"""Window seconds over the frames completed in it, in ms: the
whole window, not a median of pieces."""


def read(window):
    return window.window_s * 1e3 / window.frames
