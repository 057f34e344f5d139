"""Counted rays over the window, in millions a second: the rays each frame
or tick returns (G-buffer primaries, live path segments, shadow rays; in
the App also ReSTIR's and the SHARC update's), summed over the window,
over the window's seconds."""


def read(window):
    return window.rays / window.window_s / 1e6
