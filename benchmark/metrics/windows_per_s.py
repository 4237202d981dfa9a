"""Windows of the job over the wall seconds of its one `run_pipeline` call."""


def read(run):
    return run.windows / run.job_s if run.job_s > 0 else None
