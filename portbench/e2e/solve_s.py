"""solve_s: the window's length over the answers in it that ended
Solve_Success: seconds per certified solve, all the window's work over all
its time. No answer that succeeded gives no value."""


def read(window):
    return window.window_s / window.ok if window.ok else None
