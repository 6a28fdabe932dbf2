"""Set-up seconds: from the process's start (imports, the card's start,
weights made from the seed, the engine or model built, CUDA graphs
captured, kernels built where they are not) to the start of the window,
warm-up included."""


def read(run):
    return run.setup_s
