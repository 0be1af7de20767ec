"""The fused sampler kernels (ops/sampler_kernels.py, csrc/samplers.cu)
against the samplers' plain torch chain (scenarios/engine.py).

On the card (marked ``cuda``, skipped without a card): every branch of
every sampler the rows run (chip_smoke.SAMPLER_VARIANTS: MOLUSC rows and
the companion law, with and without the conditioned twin draws, a drawn
host and a diluting row, with and without a contrast curve) at each host
star of chip_smoke.SAMPLER_STARS, 1,000,192 draws, the sampler against
``<sampler>.plain`` on generators of one seed: every field and mask the
same bit for bit, and the ``launch.sampler.<entry>`` counters up by one
a branch. Run there with
``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_sampler_kernels.py``.

On the CPU (seconds): the wrapper's argument checks, which run before the
library is loaded; the by-value scalars against ``engine._scalars``; the
constants' float32 rounding as torch rounds a Python scalar; and that a
CPU generator takes the plain chain without loading the library or
touching the counters.
"""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from triceratops_tpu_torch.ops import sampler_kernels as sk  # noqa: E402
from triceratops_tpu_torch.priors.samplers import (  # noqa: E402
    _broken3_constants)
from triceratops_tpu_torch.scenarios import engine as eng  # noqa: E402
from triceratops_tpu_torch.utils import profiling  # noqa: E402

VARIANTS = [v[0] for v in chip_smoke.SAMPLER_VARIANTS]


@pytest.fixture(scope="module")
def card_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return chip_smoke.sampler_inputs(torch, chip_smoke.N_SAMPLER, "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("star", range(len(chip_smoke.SAMPLER_STARS)))
@pytest.mark.parametrize("variant", VARIANTS)
def test_kernel_matches_plain_on_card(card_inputs, variant, star):
    """Every field and mask of the kernel path equals the plain chain's
    bit for bit; each branch is one launch."""
    v = chip_smoke.SAMPLER_VARIANTS[VARIANTS.index(variant)]
    N = chip_smoke.N_SAMPLER
    fn, args, kw, launches = chip_smoke.sampler_case(eng, card_inputs, v,
                                                     star, N)
    want = fn.plain(torch.Generator(device="cuda").manual_seed(5), *args,
                    **kw)
    before = chip_smoke.sampler_counts(profiling)
    got = fn(torch.Generator(device="cuda").manual_seed(5), *args, **kw)
    after = chip_smoke.sampler_counts(profiling)
    rose = {k[len("launch.sampler."):]: n - before.get(k, 0)
            for k, n in after.items() if n != before.get(k, 0)}
    assert rose == launches
    assert chip_smoke.sampler_diffs(torch, want, got) == {}


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

N = 512


def _u(k, n=N, **kw):
    return [torch.rand(n, **kw) for _ in range(k)]


def _eb_kw(n=N):
    P = torch.rand(n)
    return dict(P=P, P_mean=P.mean())


@pytest.mark.parametrize("case,err,match", [
    (dict(entry="sb"), ValueError, "entry"),
    (dict(star="X"), ValueError, "star"),
    (dict(names=("P", "nope")), ValueError, "unknown"),
    (dict(names=("P", "P")), ValueError, "repeated"),
    (dict(names=("P", "a_twin")), ValueError, "twin"),
    (dict(u=_u(4)), ValueError, "uniform streams"),
    (dict(u=_u(4) + [torch.rand(N, dtype=torch.float64)]), TypeError,
     "float32"),
    (dict(u=_u(4) + [torch.rand(N + 1)]), ValueError, "shape"),
    (dict(u=_u(4) + [torch.rand(2 * N)[::2]]), ValueError, "contiguous"),
    (dict(star="P", u=_u(6), use_molusc=True, qs_in=torch.rand(N + 3)),
     ValueError, "shape"),
    (dict(star="D", idx=torch.zeros(N, dtype=torch.int32),
          pack=torch.rand(7, 9)), TypeError, "int64"),
    (dict(star="D", idx=torch.zeros(N, dtype=torch.int64),
          pack=torch.rand(7, 8)), ValueError, "shape"),
    (dict(idx=torch.zeros(N, dtype=torch.int64)), ValueError, "no idx"),
    (dict(star="S", u=_u(6)), ValueError, "LDC"),
    (dict(entry="eb"), ValueError, "periods"),
    (dict(entry="eb", perm=torch.zeros((4, N), dtype=torch.int64), **_eb_kw()),
     ValueError, "lattice"),
    (dict(entry="eb", star="P", u=_u(6), use_molusc=True, qs_in=torch.rand(N),
          idx=torch.zeros(N, dtype=torch.int64), **_eb_kw()),
     ValueError, "own draw"),
    (dict(), ValueError, "CUDA device"),
    (dict(entry="twin", star="B", perm=torch.zeros((3, N), dtype=torch.int64),
          idx=torch.zeros(N, dtype=torch.int64), pack=torch.rand(7, 9),
          **_eb_kw()), ValueError, "CUDA device"),
])
def test_launch_checks(case, err, match):
    """``launch`` raises on what the kernel does not take, before it
    loads the library: a CPU tensor that passes every other check meets
    the device check last."""
    kw = dict(entry="planet", star="T", n=N, u=_u(5),
              scalars=(2.0, 4.0, 1.0, 1.0), names=("P", "mask"))
    kw.update(case)
    lib, sk._lib = sk._lib, None
    try:
        with pytest.raises(err, match=match):
            sk.launch(kw.pop("entry"), kw.pop("star"), kw.pop("n"),
                      kw.pop("u"), kw.pop("scalars"), kw.pop("names"), **kw)
        assert sk._lib is None
    finally:
        sk._lib = lib


@pytest.mark.parametrize("x", [0.1, 2.0 / 3.0, np.float64(1.2345678901),
                               np.float32(0.3), 7, 1e-40, 3.4e38,
                               float("nan"), -17.125])
def test_by_value_rounds_as_scalars(x):
    """The kernel's by-value scalars are ``_scalars``' float32 tensors."""
    (t,) = eng._scalars("cpu", x)
    (v,) = sk.by_value(x)
    np.testing.assert_array_equal(np.float32(v), t.numpy())


def test_constants_round_as_torch():
    """A Python scalar meets a float32 tensor rounded to nearest, and
    tensor / scalar multiplies by the scalar's reciprocal rounded to
    float32 (not by the reciprocal of its float32 rounding, which differs
    at sample_rp's hot normalisation): the rounding ``consts`` gives the
    kernel."""
    c = sk.consts()
    x = torch.tensor([1.0], dtype=torch.float32)
    for got, py in ((c.G, eng.G), (c.MSUN, eng.MSUN), (c.RSUN, eng.RSUN),
                    (c.REARTH, eng.REARTH), (c.rad_per_deg, eng.PI / 180.0),
                    (c.q_twin, 0.95), (c.k_shrink, 0.999)):
        assert np.float32(got) == (x * py).numpy()[0]
    assert np.float32(c.inv_4pi2) == np.float32(1.0 / (4 * eng.PI ** 2))
    norm = _broken3_constants(0.0, -4.0, -0.5, 0.5, 3.0, 6.0, 20.0)[-1]
    assert np.float32(c.rp_hot.inv_norm) == np.float32(1.0 / norm)
    assert np.float32(c.rp_hot.inv_norm) != (np.float32(1.0)
                                             / np.float32(norm))
    codes = {name: sk.POW_CODES[sk._pow_spec(e).code] for name, e in (
        ("square", 2), ("sqrt", 0.5), ("ident", 1.0), ("recip", -1.0),
        ("third", 1.0 / 3.0), ("twenty", 1.0 / (-0.95 + 1)))}
    assert codes == dict(square="square", sqrt="sqrt", ident="ident",
                         recip="recip", third="generic", twenty="generic")


def test_cpu_takes_the_plain_chain():
    """A CPU generator runs the plain chain: the library stays unloaded and
    no launch counter moves, and ``.plain`` is the same chain."""
    inputs = chip_smoke.sampler_inputs(torch, 4096, "cpu")
    lib, sk._lib = sk._lib, None
    try:
        before = chip_smoke.sampler_counts(profiling)
        for v in chip_smoke.SAMPLER_VARIANTS:
            fn, args, kw, _ = chip_smoke.sampler_case(eng, inputs, v, 1, 4096)
            got = fn(torch.Generator().manual_seed(3), *args, **kw)
            want = fn.plain(torch.Generator().manual_seed(3), *args, **kw)
            assert chip_smoke.sampler_diffs(torch, want, got) == {}
        assert sk._lib is None
        assert chip_smoke.sampler_counts(profiling) == before
    finally:
        sk._lib = lib
