import sys
import time
from pathlib import Path

import pytest
import torch

# one thread a test process: parallel test workers do not oversubscribe
# the CPU, so a timed window holds many steps
torch.set_num_threads(1)

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from spec import Spec  # noqa: E402

#: a tiny stand-in for the Ocean fields (width not a multiple of the block,
#: so the padded blocks are exercised)
TINY_DIMS = [48, 72]
TINY_WINDOWS = [{"window": [[12, 37], [18, 55]], "count": 1},
                {"window": [[24, 27], [0, 72]], "count": 1}]


def tiny(spec: Spec, workload: str, clients: int = 6):
    """The cell's config and mix cut to a size a CPU test run holds."""
    cell = spec.workload(workload)
    config = spec.config(cell["config"])
    config.update(dims=TINY_DIMS, block=[8, 8])
    mix = spec.mix(cell["traffic"])
    mix["clients"] = clients
    return config, mix


@pytest.fixture(scope="session")
def spec():
    return Spec()


@pytest.fixture
def run_tiny(spec):
    import harness

    def run(workload, seed=2 ** 31 + 11, seconds=0.5, trace=False,
            clients=6, **kw):
        config, mix = tiny(spec, workload, clients)
        kw.setdefault("config", config)
        kw.setdefault("mix", mix)
        return harness.run_cell(spec, workload, seed, seconds, trace, "cpu",
                                time.perf_counter(), **kw)
    return run
