"""Tokens trained a second: every token of the window's steps over the
whole window."""


def read(run):
    return run.units / run.window_s
