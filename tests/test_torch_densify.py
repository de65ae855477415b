"""Port parity of densification: ``gs2d_torch.models.densify``
``densify_and_prune`` and ``reset_opacity`` against the JAX package's on
the same seeded state (a JAX state with holes in ``active`` and ample
capacity, the port holding its active rows).

Bars: the masks' counts exactly; every row of the port equal to the JAX
package's live rows exactly (survivors in slot order, new rows in the
JAX ``kk`` order, which is the order of the free slots they fill), except
split children's xyz at 1e-6 (R·ε is summed in another order); survivors'
moments exactly, new rows' moments and all statistics zero;
``reset_opacity`` at 1e-6. The split noise is the JAX draw, handed in.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2d_torch.models.densify import LOG_1_6
from gs2d_torch.models.densify import densify_and_prune as t_densify
from gs2d_torch.models.densify import reset_opacity as t_reset
from gs2d_torch.models.gaussians import state_from_numpy
from gs2d_torch.train.optim import AdamState as TAdam
from gs2d_tpu.models.densify import densify_and_prune as j_densify
from gs2d_tpu.models.densify import reset_opacity as j_reset
from gs2d_tpu.models.gaussians import GaussianParams as JParams
from gs2d_tpu.models.gaussians import GaussianState as JState
from gs2d_tpu.train.optim import AdamState as JAdam

from .test_torch_common import to_t

FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")
SHAPES = {"xyz": (3,), "features_dc": (1, 3), "features_rest": (15, 3),
          "scaling": (2,), "rotation": (4,), "opacity": (1,)}
CAP = 256
EXTENT = 2.0
PD = 0.01
THRESH = 2e-4
MIN_OP = 0.05


def _states(seed, scale_lo, scale_hi):
    """A JAX state (capacity CAP, about 70% of the slots free and
    holding garbage) with moments, and the port's copy of its live rows."""
    rng = np.random.default_rng(seed)
    active = rng.random(CAP) < 0.3
    p = {f: rng.normal(size=(CAP,) + s).astype(np.float32)
         for f, s in SHAPES.items()}
    p["scaling"] = np.log(rng.uniform(scale_lo, scale_hi, (CAP, 2))) \
        .astype(np.float32)
    op = rng.uniform(0.01, 0.99, CAP)
    p["opacity"] = np.log(op / (1 - op)).astype(np.float32)[:, None]
    denom = rng.integers(0, 6, CAP).astype(np.float32)
    stats = dict(max_radii2d=rng.uniform(0, 30, CAP).astype(np.float32),
                 grad_accum=(denom * rng.uniform(0, 4e-4, CAP))
                 .astype(np.float32),
                 denom=denom)
    mu = {f: rng.normal(size=x.shape).astype(np.float32) * 1e-3
          for f, x in p.items()}
    nu = {f: np.abs(rng.normal(size=x.shape)).astype(np.float32) * 1e-6
          for f, x in p.items()}
    js = JState(params=JParams(**{f: jnp.asarray(x) for f, x in p.items()}),
                active=jnp.asarray(active), active_sh_degree=jnp.int32(3),
                **{k: jnp.asarray(v) for k, v in stats.items()})
    jo = JAdam(mu=JParams(**{f: jnp.asarray(x) for f, x in mu.items()}),
               nu=JParams(**{f: jnp.asarray(x) for f, x in nu.items()}),
               step=jnp.int32(7))
    ts = state_from_numpy(**p, active=active, active_sh_degree=3,
                          device="cpu", **stats)
    from gs2d_torch.models.gaussians import GaussianParams as TParams
    to = TAdam(mu=TParams(**{f: to_t(x[active]) for f, x in mu.items()}),
               nu=TParams(**{f: to_t(x[active]) for f, x in nu.items()}),
               step=7)
    return js, jo, ts, to


def _jax_masks(js, max_screen_size):
    """The masks of gs2d_tpu/models/densify.py:52-73, in jnp."""
    p, act = js.params, js.active
    grads = js.grad_accum / jnp.maximum(js.denom, 1.0)
    grads = jnp.where(js.denom > 0, grads, 0.0)
    max_scale = jnp.max(jnp.exp(p.scaling), axis=-1)
    opacity = jax.nn.sigmoid(p.opacity[:, 0])
    hot = act & (grads >= jnp.float32(THRESH))
    small = max_scale <= jnp.float32(PD) * jnp.float32(EXTENT)
    clone, split = hot & small, hot & ~small
    prune = act & (opacity < jnp.float32(MIN_OP))
    if max_screen_size > 0:
        prune = prune | (act & (max_scale > 0.1 * jnp.float32(EXTENT)))
    prune = prune | split
    ok = opacity >= jnp.float32(MIN_OP)
    ok = np.asarray(ok)
    ok_clone = ok[np.asarray(clone)]
    ok_child = np.repeat(ok[np.asarray(split)], 2)
    return (np.asarray(clone), np.asarray(split), np.asarray(prune),
            int((~ok_clone).sum() + (~ok_child).sum()), int(ok_child.sum()))


def _run(seed, scale_lo, scale_hi, max_screen_size):
    js, jo, ts, to = _states(seed, scale_lo, scale_hi)
    key = jax.random.PRNGKey(seed)
    args = (THRESH, MIN_OP, EXTENT, max_screen_size, PD)
    j_s, j_o = j_densify(js, jo, key, *(jnp.float32(a) for a in args))
    clone, split, prune, culled, children = _jax_masks(js, max_screen_size)
    n_clone, n_split = int(clone.sum()), int(split.sum())
    # the JAX package draws eps (cap, 3) and gives new row kk row kk
    eps = np.asarray(jax.random.normal(key, (CAP, 3), jnp.float32))
    noise = to_t(eps[n_clone:n_clone + 2 * n_split])
    t_s, t_o, counts = t_densify(ts, to, *args, noise=noise)
    return dict(js=js, jo=jo, j_s=j_s, j_o=j_o, t_s=t_s, t_o=t_o,
                counts=counts, clone=clone, split=split, prune=prune,
                culled=culled, children=children)


def _check(r):
    c = r["counts"]
    assert (c.clone, c.split, c.pruned, c.culled, c.children) == (
        int(r["clone"].sum()), int(r["split"].sum()), int(r["prune"].sum()),
        r["culled"], r["children"])
    act = np.asarray(r["js"].active)
    kept = act & ~r["prune"]
    new_slots = np.asarray(r["j_s"].active) & ~kept
    n_keep, n_new = int(kept.sum()), int(new_slots.sum())
    n0 = int(act.sum())
    assert r["t_s"].params.xyz.shape[0] == n_keep + n_new == \
        n0 - c.pruned + c.clone + 2 * c.split - c.culled
    # rows of the JAX result: survivors in slot order, then new rows
    order = np.concatenate([np.nonzero(kept)[0], np.nonzero(new_slots)[0]])
    for f in FIELDS:
        got = getattr(r["t_s"].params, f).numpy()
        ref = np.asarray(getattr(r["j_s"].params, f))[order]
        if f == "xyz":
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6,
                                       err_msg=f)
            np.testing.assert_array_equal(got[:n_keep], ref[:n_keep])
        else:
            np.testing.assert_array_equal(got, ref, err_msg=f)
        for mom in ("mu", "nu"):
            tm = getattr(getattr(r["t_o"], mom), f).numpy()
            jm = np.asarray(getattr(getattr(r["j_o"], mom), f))[order]
            np.testing.assert_array_equal(tm, jm, err_msg=f"{mom}.{f}")
            assert not tm[n_keep:].any()
            src = np.asarray(getattr(getattr(r["jo"], mom), f))[kept]
            np.testing.assert_array_equal(tm[:n_keep], src)
    for f in ("max_radii2d", "grad_accum", "denom"):
        assert not getattr(r["t_s"], f).any()
    assert r["t_o"].step == 7 and r["t_s"].active_sh_degree == 3
    return n_keep, n_new


def test_densify_clone_only_matches_jax():
    r = _run(1, 0.001, 0.015, 0.0)   # every scale under PD · EXTENT
    c = r["counts"]
    assert c.clone > 5 and c.split == 0
    _, n_new = _check(r)
    assert n_new == c.clone - c.culled


def test_densify_split_matches_jax():
    r = _run(2, 0.002, 0.05, 0.0)
    c = r["counts"]
    assert c.split > 5 and c.clone > 0 and c.culled > 0
    _check(r)
    # the children's scales lose the jitted jnp.log(1.6) to the bit
    assert LOG_1_6 == float(jax.jit(lambda: jnp.log(1.6))())


def test_densify_prune_by_size_matches_jax():
    r = _run(3, 0.005, 0.4, 20.0)
    c = r["counts"]
    act = np.asarray(r["js"].active)
    low = np.asarray(jax.nn.sigmoid(r["js"].params.opacity[:, 0])) < MIN_OP
    by_size = c.pruned - int((act & (low | r["split"])).sum())
    assert by_size > 0 and c.split > 0
    _check(r)


def test_densify_needs_noise_of_the_split_count():
    _, _, ts, to = _states(2, 0.005, 0.08)
    with pytest.raises(ValueError, match="noise must be"):
        t_densify(ts, to, THRESH, MIN_OP, EXTENT, 0.0, PD,
                  noise=torch.zeros((1, 3)))
    with pytest.raises(ValueError, match="generator or noise"):
        t_densify(ts, to, THRESH, MIN_OP, EXTENT, 0.0, PD)
    g = torch.Generator().manual_seed(0)
    a = t_densify(ts, to, THRESH, MIN_OP, EXTENT, 0.0, PD, generator=g)
    b = t_densify(ts, to, THRESH, MIN_OP, EXTENT, 0.0, PD,
                  generator=torch.Generator().manual_seed(0))
    assert torch.equal(a[0].params.xyz, b[0].params.xyz)


def test_reset_opacity_matches_jax():
    js, jo, ts, to = _states(4, 0.005, 0.08)
    j_s, j_o = j_reset(js, jo)
    t_s, t_o = t_reset(ts, to)
    act = np.asarray(js.active)
    np.testing.assert_allclose(t_s.params.opacity.numpy(),
                               np.asarray(j_s.params.opacity)[act],
                               rtol=1e-6, atol=1e-6)
    assert float(torch.sigmoid(t_s.params.opacity).max()) <= 0.01 + 1e-6
    assert not t_o.mu.opacity.any() and not t_o.nu.opacity.any()
    torch.testing.assert_close(t_o.mu.xyz, to.mu.xyz, rtol=0, atol=0)
    torch.testing.assert_close(t_s.params.xyz, ts.params.xyz, rtol=0, atol=0)
