"""Shared set-up of the harness tests.

test_portbench_reference.py runs each configuration at a small size from
its table SMALL, which names the configurations it was written with.
Configurations added after it run at the small size of their family (a
mat twist at mat(12)), so that its small checkout builds every
configuration of BENCHMARK.json.
"""

import pytest

SMALL_LATER = {"twist225": 12}


@pytest.fixture(scope="module", autouse=True)
def _small_sizes_of_later_configs(request):
    sizes = getattr(request.module, "SMALL", None)
    if isinstance(sizes, dict):
        for name, n in SMALL_LATER.items():
            sizes.setdefault(name, n)
    yield
