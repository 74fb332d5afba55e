"""Process start to the start of the traffic: imports, the kernels' build
or load, the weights, the engine and the warm-up of the cell's shapes."""


def read(run):
    return run.setup_s
