"""solves_per_s: lanes (rows, in a serving cell) that ended with status
SOLVED, summed over every step of the window, over the window's seconds
on the host clock. The window starts at the first timed step and ends
when the first step that finishes after `--seconds` does."""


def read(run):
    return run.solved / run.window_s if run.window_s > 0 else None
