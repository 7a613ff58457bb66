"""A module-scoped fixture for the port's test files that build the JAX
package's cached layouts: after the file's last test it empties the JAX
package's shared layout-cache budget
(``gnntf_tpu.utils.idcache.GLOBAL_BUDGET.clear_all()``), so that the file
leaves no bytes there for the files that run after it in the same process
(``tests/test_hoist.py::test_layout_cache_budget_bounds_deep_stack`` caps
that budget at 8 MiB, and each cache keeps its last entry).  A file takes
it with ``from _jax_budget import release_jax_layout_caches``."""
import pytest

from gnntf_tpu.utils import idcache


@pytest.fixture(scope="module", autouse=True)
def release_jax_layout_caches():
    yield
    idcache.GLOBAL_BUDGET.clear_all()
