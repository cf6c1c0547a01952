"""The port's random weights against flax's, for the tests that hold
``utils/flax_init.py`` to flax's init: its law, ``lecun_normal()``
(``variance_scaling(1.0, "fan_in", "truncated_normal")``: a normal cut at
±2 of its own σ₀, σ₀ = fan_in**-0.5 / 0.87962566103423978), and its
values.

Each model is checked four ways:

1. every drawn weight times √fan_in is at most 2 / 0.87962566103423978
   (``check_bound``);
2. the drawn weights of models at their default configuration,
   standardised by fan-in: each model's have a standard deviation within
   2% of 1 (the cut law keeps the variance), and pooled (at least 200,000
   values; the distance is taken over about a million of them) they lie
   within Kolmogorov-Smirnov distance 0.008 of ``scipy.stats.truncnorm(-2,
   2, scale=1 / 0.87962566103423978)`` (``check_law``); a correct draw of
   that size gives well under 0.002, the plain N(0, 1/fan_in) draw 0.0166;
3. against the JAX model's tree at the tests' small configuration, by the
   rule table ``RULES`` of flax's initialisers (``check_against_jax``): the
   same parameters are drawn; each drawn tensor of at least 1024 entries
   has a fan-in-standardised standard deviation within 10% of the JAX
   tensor's (a fan-in other than flax's shows here); biases, norm scales
   and batch statistics equal exactly; the ``normal(1.0)`` parameters are
   an untruncated N(0, 1);
4. against the JAX model's ``init`` values of the same seed
   (``check_values``, the JAX side compiled lean by ``jit_init``): every
   parameter and running statistic within 4 float32 units in the last
   place.

The checks run inside existing tests, so they add no test item: check 2
(with check 1) in the ``models`` fixture of ``test_torch_modules.py``, in
``test_torch_scene.py::test_registry_and_scene_knobs`` and in
``test_torch_library_models.py::test_transformer_mask_matches_jax``.
Check 3 (with check 1) runs where a test already holds the JAX model's
tree, so it adds no JAX trace or compile: the flagship's against the JAX
``PrimitiveNet.init`` values (``test_torch_modules.py``); the others against
the tree of shapes that their parity tests fill (``jax.eval_shape``: a JAX
init of the scene model or a library module compiles for seconds),
where the JAX side is the rule's value, and a kernel's standard deviation is
that of flax's draw for its shape, by flax's fan-in rule for a
``k... x in x out`` kernel (the product of all but its last axis).  Check
4 runs where a test builds the port model from a seed: the flagship in the
``models`` fixture (its JAX init is already there), the dual, ``ablation``
and SPP-Net models in ``test_registry_and_config_take_the_variants``, the
scene model in ``test_torch_scene_trainer.py``, the library modules in
their parity tests (an init of the JAX model with ``train=False``, whose
forward XLA drops as dead code).
"""

from __future__ import annotations

import jax
import numpy as np
import scipy.stats
from scipy.special import ndtr
from torch import nn

from gcanet_tpu_torch.utils.from_jax import state_dict_from_jax
from tests.torch_once import jit_init

TRUNC_STD = 0.87962566103423978
BOUND = 2 / TRUNC_STD + 1e-6
MAX_KS = 0.008
MIN_VALUES = 200_000
KS_VALUES = 1_000_000
# the normal(1.0) tables are smaller; at 80,000 values a correct N(0, 1)
# draw lies beyond KS 0.008 with probability under 1e-4, and flax's cut
# normal lies 0.0115 from it (its mass below -2.27)
MIN_NORMAL = 80_000
STD_RTOL = 0.1

# flax leaf name -> its initialiser in the JAX package
RULES = {"kernel": "lecun", "bias": "zeros", "scale": "ones", "mean": "zeros",
         "var": "ones", "query": "normal", "pe": "normal", "cls_token": "normal",
         "pos_embedding": "normal", "temperature": "constant"}
_CODES = {"lecun": 1.0, "zeros": 2.0, "ones": 3.0, "normal": 4.0, "constant": 5.0}


def drawn(model: nn.Module) -> dict[str, tuple[np.ndarray, int]]:
    """The weights drawn from flax's truncated lecun-normal, by state_dict
    key: each with its fan-in."""
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, nn.Linear):
            fan_in = m.in_features
        elif isinstance(m, (nn.Conv3d, nn.ConvTranspose3d)):
            fan_in = m.in_channels * int(np.prod(m.kernel_size))
        else:
            continue
        out[f"{name}.weight"] = (m.weight.detach().numpy(), fan_in)
    return out


def standardised(model: nn.Module) -> np.ndarray:
    """Every drawn weight of ``model``, times √fan_in, in one float32 vector."""
    return np.concatenate([w.ravel() * np.float32(np.sqrt(f)) for w, f in drawn(model).values()])


def check_bound(model: nn.Module) -> None:
    for key, (w, fan_in) in drawn(model).items():
        largest = float(np.abs(w).max()) * np.sqrt(fan_in)
        assert largest <= BOUND, f"{key}: |w|·√fan_in = {largest:.4f} > {BOUND:.4f}"


def ks_distance(x: np.ndarray, cdf) -> float:
    """Kolmogorov-Smirnov distance of ``x`` to ``cdf``, over at most about
    a million of its values (every k-th: the draws are independent)."""
    x = np.sort(x[::max(1, x.size // KS_VALUES)]).astype(np.float64)
    f = cdf(x)
    n = x.size
    return float(max((np.arange(1, n + 1) / n - f).max(), (f - np.arange(n) / n).max()))


def truncnorm_cdf(x: np.ndarray) -> np.ndarray:
    """``scipy.stats.truncnorm(-2, 2, scale=1 / TRUNC_STD).cdf`` in closed
    form (scipy's takes 0.7 s a million values)."""
    lo, hi = ndtr(-2.0), ndtr(2.0)
    return np.clip((ndtr(x * TRUNC_STD) - lo) / (hi - lo), 0.0, 1.0)


def check_law(models) -> None:
    """Check 2 over ``models``, with check 1 on each: one message gives
    every model's std·√fan_in, the pooled KS distance and the largest
    |w|·√fan_in."""
    grid = np.linspace(-2.5, 2.5, 101)
    np.testing.assert_allclose(truncnorm_cdf(grid), scipy.stats.truncnorm(
        -2, 2, scale=1 / TRUNC_STD).cdf(grid), rtol=0, atol=1e-12)
    pooled = [standardised(m) for m in models]
    stds = [float(x.std(dtype=np.float64)) for x in pooled]
    x = np.concatenate(pooled)
    assert x.size >= MIN_VALUES, x.size
    d, largest = ks_distance(x, truncnorm_cdf), float(np.abs(x).max())
    # the cut law keeps the variance: 1 standardised (2% is 6 sigmas at 50,000)
    assert largest <= BOUND and d <= MAX_KS and all(abs(v - 1) <= 0.02 for v in stds), (
        f"KS distance {d:.4f} to flax's truncated normal, largest |w|·√fan_in "
        f"{largest:.3f} (cut {BOUND:.4f}), std·√fan_in by model {[round(v, 4) for v in stds]}")


def check_normal_law(values: np.ndarray) -> None:
    """The ``normal(1.0)`` parameters, pooled: untruncated N(0, 1)."""
    assert values.size >= MIN_NORMAL, values.size
    assert np.abs(values).max() > 2 / TRUNC_STD         # tails beyond flax's cut
    d = ks_distance(values, ndtr)
    assert d <= MAX_KS, f"KS distance {d:.4f} to N(0, 1)"


def _rule(path) -> str:
    return RULES[path[-1].key]


def check_against_jax(model: nn.Module, params, stats, family: str, values: bool) -> None:
    """Check 3: ``model`` (the port's draw) against the JAX tree ``(params,
    stats)`` of the same model, as numpy values (``values=True``) or as
    ``jax.eval_shape`` leaves), after check 1 on ``model``."""
    check_bound(model)

    def marks(tree):
        return jax.tree_util.tree_map_with_path(
            lambda p, s: np.full(s.shape, _CODES[_rule(p)], np.float32), tree)

    code = {k: float(v.flatten()[0]) for k, v in
            state_dict_from_jax(marks(params), marks(stats) if stats else None,
                                family=family).items()}
    port = {k: v.numpy() for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}
    assert set(port) == set(code), set(code) ^ set(port)
    draws = drawn(model)
    assert set(draws) == {k for k, c in code.items() if c == _CODES["lecun"]}

    flax_std = {}                          # the JAX draw's σ, in port keys
    if values:
        want = {k: v.numpy() for k, v in state_dict_from_jax(params, stats, family=family).items()}
        for k in draws:
            flax_std[k] = float(want[k].std())
    else:
        def sigma(p, s):
            if _rule(p) != "lecun":
                return np.zeros(s.shape, np.float32)
            fan_in = int(np.prod(s.shape[:-1]))
            return np.full(s.shape, fan_in ** -0.5, np.float32)
        sig = state_dict_from_jax(jax.tree_util.tree_map_with_path(sigma, params),
                                  None, family=family)
        flax_std = {k: float(sig[k].flatten()[0]) for k in draws}
        want = {}
    for k, (w, fan_in) in draws.items():
        if w.size >= 1024:
            got, ref = w.std() * np.sqrt(fan_in), flax_std[k] * np.sqrt(fan_in)
            assert abs(got / ref - 1) <= STD_RTOL, f"{k}: std·√fan_in {got:.4f} vs JAX {ref:.4f}"
    fixed = {_CODES["zeros"]: 0.0, _CODES["ones"]: 1.0}
    for k, c in code.items():
        if c in fixed:
            np.testing.assert_array_equal(port[k], fixed[c], err_msg=k)
            if values:
                np.testing.assert_array_equal(port[k], want[k], err_msg=k)
        elif c == _CODES["normal"]:
            assert 0.5 < port[k].std() < 1.5 and np.abs(port[k]).max() > 0, k


MAX_ULPS = 4


def ulps(a: np.ndarray, b: np.ndarray) -> int:
    """The largest gap between two float32 arrays in units in the last
    place (the distance of their bit patterns on the ordered integer line)."""
    ia, ib = (np.asarray(x, np.float32).view(np.int32).astype(np.int64) for x in (a, b))
    ia, ib = (np.where(i < 0, -(i & 0x7FFFFFFF), i) for i in (ia, ib))
    return int(np.abs(ia - ib).max()) if ia.size else 0


def jax_init(init, seed: int):
    """``init(PRNGKey(seed))`` (a flax ``init``) compiled lean
    (``jit_init``), as numpy ``(params, batch_stats)``."""
    v = jax.tree.map(np.asarray, jit_init(init, jax.random.PRNGKey(seed)))
    return v["params"], v.get("batch_stats") or None


def check_values(model: nn.Module, params, stats, family: str) -> None:
    """The port's seeded init ``model`` against the JAX model's ``init``
    values ``(params, stats)`` of the same seed: every parameter and
    running statistic within ``MAX_ULPS`` float32 units in the last place
    (the port's own copy of JAX's stream gives them bit for bit on the
    CPU)."""
    want = state_dict_from_jax(params, stats, family=family)
    got = model.state_dict()
    assert set(want) <= set(got), set(want) - set(got)
    worst = max((ulps(got[k].numpy(), w.numpy()), k) for k, w in want.items())
    assert worst[0] <= MAX_ULPS, f"{worst[1]}: {worst[0]} ulps from the JAX init"
