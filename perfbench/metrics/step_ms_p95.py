"""The 95th percentile of every timed step's time, from the start of the
batch fetch to the rows on the host: CUDA events recorded on the
device's clock at the step's start and after the host has the rows (the
stream is idle at both, one batch being in flight)."""
import numpy as np


def read(run):
    return float(np.percentile(run.step_ms, 95)) if run.step_ms else None
