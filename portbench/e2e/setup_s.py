"""setup_s: seconds from the process's start to the window's start (loading,
building the kernels on a checkout's first run, warming up)."""


def read(window):
    return window.setup_s
