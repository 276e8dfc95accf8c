"""Seconds from the start of the process to the opening of the window:
imports, the card's start-up, the inputs, the session's prep (and a first
run's kernel build) and the warm-up calls."""


def read(run):
    return run.setup_s
