"""The port's flash ceiling probe kernel (paddle_tpu_torch/ops/kernels/
flash_ceiling.py) against the probe's Pallas kernel run in interpret mode.

The probe's kernel ``kern`` is local to ``main()`` of
benchmarks/exp_flash_ceiling.py and cannot be imported, so
``_pallas_probe`` restates it (:48-87) and its ``pallas_call`` (:103-121)
line for line, at BH=2 T=256 D=16.  On the CPU the port's wrapper takes
its plain version, so this pins the function the CUDA kernel is held to
on the card (chip_smoke.py).

Tolerance, norm-relative (the gap's norm over the reference's):
float32 1e-5 (both sum float32 products in other orders; read here:
2.3e-7 at most); bfloat16 5e-4: both sides round p to bfloat16 before
p v, and a last-bit difference in s can move a term by a bfloat16 ulp
(2^-8 relative) now and then (read here: 0).  Leaving out the cast of p
moves every term instead: 2.3e-3 or more, which
``test_bf16_bound_catches_a_missing_cast`` holds outside the bound.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from paddle_tpu_torch.ops.kernels import flash_ceiling as fc

BH, T, D = 2, 256, 16
TOL = {'float32': 1e-5, 'bfloat16': 5e-4}
_JNP = {'float32': jnp.float32, 'bfloat16': jnp.bfloat16}
_TORCH = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def _pallas_probe(variant, q, k, v, bq, bk):
    """exp_flash_ceiling.py's kernel and call for ``variant``, in
    interpret mode."""
    bh, t, d = q.shape
    nk = t // bk
    kt = variant.endswith('T')

    def kern(q_ref, k_ref, v_ref, o_ref, acc_scr):
        ki = pl.program_id(2)
        qi = pl.program_id(1)

        @pl.when(ki == 0)
        def _init():
            acc_scr[...] = jnp.zeros_like(acc_scr[...])

        alive = (qi * bq + bq - 1) >= (ki * bk)

        @pl.when(alive)
        def _compute():
            q = q_ref[0]
            k = k_ref[0]
            v = v_ref[0]
            if kt:
                s = jax.lax.dot_general(
                    q, k, (((1,), (0,)), ((), ())),
                    preferred_element_type=jnp.float32)
            else:
                s = jax.lax.dot_general(
                    q, k, (((1,), (1,)), ((), ())),
                    preferred_element_type=jnp.float32)
            if variant.startswith('mm'):
                p = s
            elif variant == 'exp':
                p = jnp.exp(s)
            else:
                p = jnp.exp(s - jnp.max(s, axis=1)[:, None])
            acc_scr[...] += jax.lax.dot_general(
                p.astype(v.dtype), v, (((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32)

        @pl.when(ki == nk - 1)
        def _fin():
            o_ref[0] = acc_scr[...].astype(o_ref.dtype)

    kspec = (pl.BlockSpec((1, d, bk), lambda b, i, j: (b, 0, j)) if kt
             else pl.BlockSpec((1, bk, d), lambda b, i, j: (b, j, 0)))
    run = pl.pallas_call(
        kern, grid=(bh, t // bq, nk),
        in_specs=[pl.BlockSpec((1, bq, d), lambda b, i, j: (b, i, 0)),
                  kspec,
                  pl.BlockSpec((1, bk, d), lambda b, i, j: (b, j, 0))],
        out_specs=pl.BlockSpec((1, bq, d), lambda b, i, j: (b, i, 0)),
        out_shape=jax.ShapeDtypeStruct((bh, t, d), q.dtype),
        scratch_shapes=[pltpu.VMEM((bq, d), jnp.float32)],
        compiler_params=pltpu.CompilerParams(
            dimension_semantics=('parallel', 'parallel', 'arbitrary'),
            vmem_limit_bytes=64 * 1024 * 1024),
        interpret=True)
    return run(q, jnp.swapaxes(k, 1, 2) if kt else k, v)


def _inputs(seed, dtype, t=T, d=D):
    """The probe's inputs at a small shape: normals, q and k times 0.1."""
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(BH, t, d)) * mul).astype(np.float32)
            for mul in (0.1, 0.1, 1.0)]


def _norm_rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('bq,bk', [(64, 64), (128, 64), (64, 128)])
@pytest.mark.parametrize('variant', list(fc.VARIANTS))
def test_plain_matches_pallas_interpret(variant, bq, bk, dtype):
    q, k, v = _inputs(bq + 3 * bk, dtype)
    jq, jk, jv = (jnp.asarray(x, _JNP[dtype]) for x in (q, k, v))
    want = np.asarray(_pallas_probe(variant, jq, jk, jv, bq, bk)
                      .astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(x).to(_TORCH[dtype]) for x in (q, k, v))
    if variant == 'mmT':
        tk = tk.transpose(1, 2).contiguous()
    got = fc.flash_ceiling(tq, tk, tv, variant, bq, bk)
    assert got.dtype == _TORCH[dtype] and got.shape == (BH, T, D)
    assert _norm_rel(got.float().numpy(), want) <= TOL[dtype]


# the layouts the kernel's 16-bit engine stages differently (csrc/
# flash_ceiling.cu ceil16_block): a head dim that is no multiple of 8
# (thread staging), the 128 tier, mmT's transposed k tile with bq != bk
# either way at the 64 tier, and T one tile
BF16_LAYOUTS = (
    [('d33', v, 256, 33, 64, 128) for v in fc.VARIANTS]
    + [('d128', v, 256, 128, 128, 64) for v in fc.VARIANTS]
    + [('mmT_bq128_bk64', 'mmT', 256, 64, 128, 64),
       ('mmT_bq64_bk128', 'mmT', 256, 64, 64, 128)]
    + [('one_tile', v, 64, 64, 64, 64) for v in fc.VARIANTS])


@pytest.mark.parametrize('case,variant,t,d,bq,bk', BF16_LAYOUTS,
                         ids=['%s-%s' % c[:2] for c in BF16_LAYOUTS])
def test_plain_matches_pallas_interpret_bf16_layouts(case, variant, t, d,
                                                     bq, bk):
    """The plain version, which the card holds the 16-bit engine to,
    against the probe's kernel in bfloat16 at the shapes that engine
    stages apart from the main one."""
    q, k, v = _inputs(t + d + bq + 3 * bk, 'bfloat16', t, d)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(_pallas_probe(variant, jq, jk, jv, bq, bk)
                      .astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    if variant == 'mmT':
        tk = tk.transpose(1, 2).contiguous()
    got = fc.flash_ceiling(tq, tk, tv, variant, bq, bk)
    assert got.dtype == torch.bfloat16 and got.shape == (BH, t, d)
    assert _norm_rel(got.float().numpy(), want) <= TOL['bfloat16']


def test_live_tiles_and_executed_match_the_probe():
    # exp_flash_ceiling.py:95-97 at its default shape: bq = bk = 1024 at
    # T = 8192 leaves 36 of 64 tiles
    assert fc.live_tiles(8192, 1024, 1024) == 36
    assert fc.executed_flops(128, 8192, 64, 1024, 1024) == \
        4 * 8192 * 8192 * 64 * 128 * (36 / 64)
    assert fc.live_tiles(256, 64, 128) == sum(
        1 for qi in range(4) for ki in range(2) if qi * 64 + 63 >= ki * 128)


@pytest.mark.parametrize('bad', [
    dict(bq=32), dict(bk=96), dict(bq=512), dict(variant='full'),
])
def test_shapes_the_kernel_does_not_take_raise(bad):
    args = dict(variant='mm', bq=64, bk=64)
    args.update(bad)
    q = torch.zeros((1, 256, 16))
    with pytest.raises(ValueError):
        fc.flash_ceiling(q, q, q, args['variant'], args['bq'], args['bk'])


def test_mmT_takes_k_transposed():
    q = torch.zeros((1, 128, 16))
    with pytest.raises(ValueError):
        fc.flash_ceiling(q, q, q, 'mmT', 64, 64)
    with pytest.raises(TypeError):
        fc.flash_ceiling(q.half(), q.half(), q.half(), 'mm', 64, 64)


@pytest.mark.parametrize('variant', list(fc.VARIANTS))
def test_bf16_bound_catches_a_missing_cast(variant):
    """A planted fault: p summed into p v unrounded (no cast to v's dtype)
    lands outside the bfloat16 bound against the probe's kernel."""
    bq = bk = 64
    q, k, v = _inputs(bq + 3 * bk, 'bfloat16')
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(_pallas_probe(variant, jq, jk, jv, bq, bk)
                      .astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16).float()
                  for x in (q, k, v))
    out = torch.zeros((BH, T, D))
    for qi in range(T // bq):
        for ki in range(qi * bq // bk + 1):
            s = torch.bmm(tq[:, qi * bq:(qi + 1) * bq],
                          tk[:, ki * bk:(ki + 1) * bk].transpose(1, 2))
            if variant == 'exp':
                s = torch.exp(s)
            elif variant == 'maxexp':
                s = torch.exp(s - s.amax(dim=-1, keepdim=True))
            out[:, qi * bq:(qi + 1) * bq] += torch.bmm(
                s, tv[:, ki * bk:(ki + 1) * bk])
    got = out.to(torch.bfloat16).float().numpy()
    assert _norm_rel(got, want) > TOL['bfloat16']
