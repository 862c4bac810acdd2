"""screen_rate: the lanes (contingencies) in the window that ended
Solve_Success, over the window's length."""


def read(window):
    return window.ok / window.window_s
