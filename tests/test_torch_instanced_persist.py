"""The port's nearest-first two-level walk (plain version) against
gfxexp_tpu's persistent two-level Pallas kernel, the JAX default for
instanced scenes, run in interpret mode with rows=8, pool=16 (as
tests/test_torch_traverse.py runs kernel 1) on tests/test_persistent_inst.py's
scenes. Bars: torch_scenes.check_against_jax."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")
import torch_scenes as S  # noqa: E402

from gfxexp_torch.accel.instanced import (  # noqa: E402
    build_instanced as t_build,
)
from gfxexp_torch.accel.instanced import (  # noqa: E402
    intersect_any_instanced,
    intersect_closest_instanced,
)
from gfxexp_tpu.accel.pallas_persistent_inst import (  # noqa: E402
    _traverse_persistent_inst,
    intersect_any_persistent_inst,
)
from gfxexp_tpu.accel.pallas_widestack import (  # noqa: E402
    build_instanced as j_build,
)

torch.set_num_threads(2)
CASES = S.instanced_walk_cases()
SMALL = dict(rows=8, pool=16)


@pytest.mark.parametrize("key", list(CASES))
def test_nearest_first_matches_jax_persistent(key):
    geoms, inst, rebraid, o, d = CASES[key]
    jacc, _ = j_build(geoms, inst, rebraid=rebraid)
    tacc, _ = t_build(geoms, inst, rebraid=rebraid)
    jh, ji = _traverse_persistent_inst(jacc, jnp.asarray(o), jnp.asarray(d),
                                       1e-4, 1e30, any_hit=False, **SMALL)
    # the default route (GFXEXP_PERSIST unset) is the nearest-first walk
    h, inst_t = intersect_closest_instanced(tacc, torch.from_numpy(o),
                                            torch.from_numpy(d))
    S.check_against_jax(h, inst_t, jh, ji)


def test_any_hit_matches_jax_persistent():
    geoms, inst, rebraid, o, d = CASES["ragged"]
    jacc, _ = j_build(geoms, inst, rebraid=rebraid)
    tacc, _ = t_build(geoms, inst, rebraid=rebraid)
    ref = np.asarray(intersect_any_persistent_inst(
        jacc, jnp.asarray(o), jnp.asarray(d), **SMALL))
    got = intersect_any_instanced(tacc, torch.from_numpy(o),
                                  torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert ref.any()
