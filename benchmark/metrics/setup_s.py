"""Seconds from the process's start to the window's: imports, the card's
start, kernel builds or loads, the stream's rendering and the untimed
warm-up that captures every region the window replays."""


def read(run):
    return run["setup_s"]
