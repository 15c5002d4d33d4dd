"""The least time the traced requests need (their least bytes once over
the device's memory rate, ``roofline.py``) over the device's busy time in
the traced window."""
import roofline


def read(run):
    if run.trace is None or run.trace["busy_s"] <= 0 or run.traced_bytes <= 0:
        return None
    return 100.0 * roofline.least_seconds(run.traced_bytes) / run.trace["busy_s"]
