"""Set-up seconds: process start to the first timed step (torch and CUDA
initialisation, the kernel build where the checkout has none yet, the scene,
the pair-capacity probe over the poses, the warm-up: one cycle of every
pose, then on for the mix's ``warmup_seconds``)."""


def read(run):
    return run.setup_s
