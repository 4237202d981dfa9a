"""Seconds from the process's start to the job's start: torch and the port
loaded, the CUDA context, the inputs made, the warm job run."""


def read(run):
    return run.setup_s
