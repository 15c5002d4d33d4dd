"""The 95th percentile of every answered request's time, arrival to the
end of the step that answered it, by the host clock (steps of a few
milliseconds, so it is a layer's reading and bears no bound)."""
import statistics


def read(run):
    if len(run.latencies_s) < 2:
        return None
    return statistics.quantiles(run.latencies_s, n=100,
                                method="inclusive")[94] * 1e3
