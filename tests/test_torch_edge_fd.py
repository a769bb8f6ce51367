"""The port's edge-sampled gradients against finite differences of its own
renders, on the CPU: tests/test_edge_grad.py's checks (:73, :112, :147,
:219, :284) on raytracer_tpu_torch's diff/edges and render, with their
scenes, keys, sample counts, calibrations and tolerances
(raytracer_tpu_torch/diff/edge_fd.py builds the fixtures and computes
each estimator and finite difference). No JAX: the port is held to
itself. Slow, as the originals are (64-spp finite-difference renders).
"""
import numpy as np
import pytest

from raytracer_tpu_torch.diff import edge_fd

pytestmark = pytest.mark.slow

CPU = 'cpu'


def test_shadow_edge_grad_matches_fd():
    """Hard shadow boundary: the primary-edge term is blind (the blocker
    is out of frame); the shadow-edge term reproduces the finite
    difference."""
    r = edge_fd.shadow(CPU)
    fd, g_sh, g_ns = r['fd'], r['grad'], r['blind']
    assert np.isfinite(fd) and abs(fd) > 0.1, fd
    assert abs(g_ns) < 0.15 * abs(fd), (g_ns, fd)
    assert np.sign(g_sh) == np.sign(fd), (g_sh, fd)
    np.testing.assert_allclose(g_sh, fd, rtol=0.3)
    assert edge_fd.holds(r)


def test_shadow_fit_converges():
    """Inverse rendering through the shadow alone: the blocker moves
    toward the +0.25 target and the loss halves."""
    r = edge_fd.shadow_fit(CPU)
    losses = r['losses']
    assert losses[-1] < 0.5 * losses[0], losses
    assert r['moved'] > 0.08, r['moved']


def test_edge_grad_matches_fd_on_silhouette():
    """A triangle's silhouette: the interior gradient is blind, the
    edge-sampled boundary term reproduces the finite difference."""
    r = edge_fd.silhouette(CPU)
    fd, g_dx, g_int_dx = r['fd'], r['grad'], r['blind']
    assert np.isfinite(fd) and abs(fd) > 0.05, fd
    assert abs(g_int_dx) < 0.25 * abs(fd), (g_int_dx, fd)
    assert np.sign(g_dx) == np.sign(fd), (g_dx, fd)
    np.testing.assert_allclose(g_dx, fd, rtol=0.25)
    assert edge_fd.holds(r)


def test_instanced_edge_grad_matches_fd():
    """The (instance, edge) pairs of three instances of one triangle: the
    prototype's x-translation derivative matches the finite difference."""
    r = edge_fd.instanced(CPU)
    assert r['pairs'] == 9                   # 3 instances x 3 edges
    fd, dldx = r['fd'], r['grad']
    assert fd != 0.0
    assert np.sign(dldx) == np.sign(fd)
    assert abs(dldx - fd) < 0.35 * abs(fd) + 1e-4, (dldx, fd)
    assert edge_fd.holds(r)


def test_gi_edge_grad_matches_fd():
    """GI boundary: the blocker seen from the first diffuse vertex; without
    GI edges the blocker's gradient is exactly zero."""
    r = edge_fd.gi(CPU)
    fd, g0, g1 = r['fd'], r['blind'], r['grad']
    assert np.isfinite(fd) and abs(fd) > 0.05, r['fds']
    assert abs(g0) < 1e-6, g0
    assert np.sign(g1) == np.sign(fd), (g1, fd)
    np.testing.assert_allclose(g1, fd, rtol=0.35)
    assert edge_fd.holds(r)
