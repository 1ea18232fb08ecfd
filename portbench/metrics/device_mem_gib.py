"""The allocator's peak over the program's set-up and the window (reset
once the benchmark has made its inputs and freed its own device copies),
in GiB: the vector database's space cost on the card."""


def read(run):
    return run.mem_peak_bytes / 2**30 if run.mem_peak_bytes else None
