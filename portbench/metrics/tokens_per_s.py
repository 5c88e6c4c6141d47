"""Tokens scored in the window, every call's, over the window's seconds
(host clock, from the first call's start to the last call's end)."""


def read(run):
    return run.work["items"] * run.calls / run.window_s
