"""Queries answered over the whole window: queries returned / window seconds."""


def read(run):
    return run.returned / run.window_s if run.window_s > 0 else None
