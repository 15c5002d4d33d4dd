"""Process start to the first timed request: imports, kernel load, fields
made, compressed and stored on the device, warm-up steps."""


def read(run):
    return run.setup_s
