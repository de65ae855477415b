"""The port's IG2G analysis (``gs2d_torch/ig2g/analysis.py``) against
``gs2d_tpu.ig2g.analysis`` on the same seeded arrays: spectra and
similarities in float64 within 1e-10 relative; the DDPM sampler step by
step on the same ε-predictor and the same NumPy-drawn noise (each package's
normal draw patched in the test only) at the float32 bar, rtol 1e-5 /
atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2d_torch.ig2g import analysis as ours
from gs2d_torch.ig2g.ops import DDIMSchedule
from gs2d_tpu.ig2g import analysis as ref
from gs2d_tpu.ig2g.ops import DDIMSchedule as JaxDDIMSchedule

from .test_torch_common import one_torch_thread  # noqa: F401

REL = 1e-10


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(got - want).max()) <= rel * scale


def _inputs():
    rng = np.random.default_rng(0)
    return {"rgb_64x48": rng.random((3, 64, 48)),
            "gray_33x17": rng.random((33, 17)),
            "latent_4x9x12": rng.normal(size=(4, 9, 12)).astype(np.float32)}


@pytest.mark.parametrize("name", list(_inputs()))
def test_spectra_match_jax(name):
    x = _inputs()[name]
    _close(ours.power_spectrum_2d(x, device="cpu"), ref.power_spectrum_2d(x))
    for n_bins in (64, 7):
        _close(ours.radial_spectrum(x, n_bins, device="cpu"),
               ref.radial_spectrum(x, n_bins))


def test_spectrum_similarity_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(3, 40, 40))
    b = np.cumsum(rng.normal(size=(3, 40, 40)), axis=2)
    for x, y in ((a, b), (a, a), (b, a[0])):
        _close(ours.spectrum_similarity(x, y, device="cpu"),
               ref.spectrum_similarity(x, y))


@pytest.mark.parametrize("metric", ["l2", "cosine", "spectrum"])
def test_similarity_matrix_matches_jax(metric):
    rng = np.random.default_rng(2)
    a = rng.normal(size=(3, 16, 16))
    imgs = [a, a + rng.normal(scale=0.01, size=a.shape),
            rng.normal(size=a.shape), np.roll(a, 3, axis=1)]
    _close(ours.image_similarity_matrix(imgs, metric, device="cpu"),
           ref.image_similarity_matrix(imgs, metric))
    with pytest.raises(ValueError):
        ours.image_similarity_matrix(imgs, "l1", device="cpu")


@pytest.mark.parametrize("num_steps", [50, 7])
def test_ddpm_sample_matches_jax_step_by_step(monkeypatch, num_steps):
    """The same ε-predictor (aimed at a fixed x0) and the same noise: the
    x handed to the predictor at every step and the result agree; the
    caller's schedules are left as they were."""
    shape = (1, 2, 8, 8)
    rng = np.random.default_rng(3)
    draws = [rng.normal(size=shape).astype(np.float32)
             for _ in range(num_steps + 1)]
    target = 0.37

    def replay(wrap):
        it = iter(draws)
        return lambda *a, **k: wrap(next(it))

    monkeypatch.setattr(jax.random, "normal", replay(jnp.asarray))
    monkeypatch.setattr(torch, "randn", replay(torch.from_numpy))
    seen_jax, seen_ours = [], []
    jsched, tsched = JaxDDIMSchedule(), DDIMSchedule()

    def jax_eps(x, t):
        seen_jax.append((t, np.asarray(x)))
        a = jsched.alphas_cumprod[t]
        return (x - jnp.sqrt(a) * target) / jnp.sqrt(1 - a)

    def torch_eps(x, t):
        seen_ours.append((t, x.numpy().copy()))
        a = tsched.alphas_cumprod[t]
        return (x - torch.sqrt(a) * target) / torch.sqrt(1 - a)

    want = ref.ddpm_sample(jax_eps, shape, jax.random.PRNGKey(0),
                           num_steps=num_steps, schedule=jsched)
    got = ours.ddpm_sample(torch_eps, shape, torch.Generator(),
                           num_steps=num_steps, schedule=tsched,
                           device="cpu")
    assert [t for t, _ in seen_ours] == [t for t, _ in seen_jax]
    assert len(seen_ours) == num_steps
    for (_, a), (_, b) in zip(seen_ours, seen_jax):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert not hasattr(tsched, "timesteps")
    if num_steps == 50:
        assert float(np.abs(got.numpy() - target).mean()) < 0.05


def test_ddpm_sample_draws_from_the_generator():
    """Two runs from one seed agree bit for bit, another seed differs."""
    def eps(x, t):
        return 0.5 * x

    def run(seed):
        return ours.ddpm_sample(eps, (1, 1, 4, 4),
                                torch.Generator().manual_seed(seed),
                                num_steps=5, device="cpu")

    assert torch.equal(run(0), run(0)) and not torch.equal(run(0), run(1))


def test_plot_spectra_writes_a_png(tmp_path):
    rng = np.random.default_rng(4)
    path = tmp_path / "spectra.png"
    assert ours.plot_spectra([rng.random((3, 16, 16))], ["noise"],
                             str(path))
    assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
