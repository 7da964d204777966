"""Differentiable rollouts of the port (``nbody_tpu_torch.autodiff``) and
the VJPs under them, on the CPU, each held against ``nbody_tpu`` on the
same numpy inputs, value and gradient.

* every case of tests/test_autodiff.py under the port's backend names
  ("torch" for "jnp"; "cuda" needs the card, so its cases are in
  tests/test_torch_kernels.py and here it must be refused), with that
  file's tolerances, plus the rollout cases of tests/test_extra_force.py
  and tests/test_integrators.py;
* ``force_acc_vjp_plain`` against ``jax.vjp`` of
  ``nbody_tpu.forces.direct_sum_acc`` and ``pp_cells_vjp_plain`` against
  ``jax.vjp`` of ``_pp_blocks_jnp`` (what JAX's custom VJPs compute),
  within 1e-5 of max|ref| per cotangent: the same fp32 formula, summed in
  another order;
* the CPU sqrt's gradient bit for bit against ``jax.grad(jnp.sqrt)``, and
  the gradients of the row gather and of ``forces.add_at``.

A zero-radius target on a source at its own position (the softening
floor's trap) has r2 = 1e-18: JAX's precise VJP gives NaN there (0 · inf in
the division's adjoint) and the port's gives the finite limit, 0; the
test holds the port to 0 and to JAX's rsqrt VJP, which is finite.
"""

import jax  # noqa: F401  (tests/conftest.py pins it to the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import random_arrays, rel_err

import nbody_tpu as nb
from nbody_tpu import autodiff as jad
from nbody_tpu import forces as jforces
from nbody_tpu.ops import p3m_pallas
from nbody_tpu.parallel.sharding import make_mesh as jax_mesh

import nbody_tpu_torch as nt
from nbody_tpu_torch import autodiff as tad
from nbody_tpu_torch import forces as tforces
from nbody_tpu_torch.ops import direct_forces as df
from nbody_tpu_torch.ops import p3m_forces as tp3m
from nbody_tpu_torch.ops import p3m_pp as pp
from nbody_tpu_torch.parallel import make_mesh

DT = 0.01
FLOOR = 1e-18
# force_acc_vjp_plain / pp_cells_vjp_plain against jax.vjp: max|d|/max|ref|
TOL_VJP = 1e-5
CPU4 = ["cpu"] * 4


def T(a, grad=False):
    """A float32 CPU tensor of a numpy or jax array (copied)."""
    t = torch.tensor(np.array(a, np.float32))
    return t.requires_grad_() if grad else t


def J(a):
    return jnp.asarray(np.asarray(a, np.float32))


def sun_and_probe():
    """Heavy stationary body + light probe (tests/test_autodiff.py)."""
    pos = np.array([[0.0, 0.0], [100.0, 0.0]], np.float32)
    vel = np.array([[0.0, 0.0], [0.0, 5.0]], np.float32)
    mass = np.array([1e5, 0.0], np.float32)
    radius = np.array([1.0, 0.5], np.float32)
    return pos, vel, mass, radius


def galaxy_state(n, seed, galaxies=1):
    """numpy (pos, vel, mass, radius) of a scene in massive-first order and
    its mass_len, as nbody_tpu's World holds it."""
    w = nb.create_world(nb.make_galaxies(n, galaxies, seed=seed))
    h = w.particles
    return [np.asarray(x, np.float32) for x in (h.pos, h.vel, h.mass,
                                                h.radius)], w.mass_len


def grad_of(loss, *args):
    """(value, gradients) of a torch loss of CPU tensors made from args."""
    ts = [T(a, grad=True) for a in args]
    val = loss(*ts)
    grads = torch.autograd.grad(val, ts)
    return float(val), [g.numpy() for g in grads]


# -- the rollouts: tests/test_autodiff.py ---------------------------------

def test_rollout_matches_world_and_jax():
    pos, vel, mass, radius = sun_and_probe()
    p, _ = tad.rollout(T(pos), T(vel), T(mass), T(radius), 0.01, n_steps=50,
                       mass_len=1)
    w = nt.create_world(nt.make_particles(pos, vel=vel, mass=mass,
                                          radius=radius),
                        config=nt.SimConfig(precise=True), device="cpu")
    w.update(0.01, 50, backend="torch")
    assert torch.equal(p, w.particles.pos)
    pj, _ = jad.rollout(J(pos), J(vel), J(mass), J(radius), jnp.float32(0.01),
                        n_steps=50, mass_len=1)
    np.testing.assert_allclose(p.numpy(), np.asarray(pj), rtol=1e-5,
                               atol=1e-4)


def test_grad_matches_finite_difference_and_jax():
    pos, vel, mass, radius = sun_and_probe()
    loss_t = tad.trajectory_loss(torch.tensor([0.0, 120.0]), index=1)
    loss_j = jad.trajectory_loss(jnp.array([0.0, 120.0], jnp.float32), index=1)

    def f(vy):
        v = torch.tensor(vel).index_put((torch.tensor(1), torch.tensor(1)),
                                        vy.reshape(()))
        return loss_t(T(pos), v, T(mass), T(radius), 0.01, n_steps=30,
                      mass_len=1)

    vy = torch.tensor(5.0, requires_grad=True)
    (g,) = torch.autograd.grad(f(vy), vy)
    with torch.no_grad():
        eps = 1e-2
        fd = (f(torch.tensor(5.0 + eps)) - f(torch.tensor(5.0 - eps))) / (2 * eps)
    assert float(g) == pytest.approx(float(fd), rel=0.05)

    def fj(vy):
        v = J(vel).at[1, 1].set(vy)
        return loss_j(J(pos), v, J(mass), J(radius), jnp.float32(0.01),
                      n_steps=30, mass_len=1)

    assert float(g) == pytest.approx(float(jax.grad(fj)(jnp.float32(5.0))),
                                     rel=1e-4)


@pytest.mark.parametrize("backend,kw", [
    ("torch", {}), ("pm", {"pm_grid": 64}),
    ("p3m", {"pm_grid": 64, "p3m_cell_capacity": 16, "p3m_exact_targets": 4}),
])
def test_remat_equals_no_remat(backend, kw):
    """remat recomputes each step in the backward: the values, and here the
    gradients too, are bit-equal without it."""
    (pos, vel, mass, radius), ml = galaxy_state(200, 3)

    def run(remat):
        p = T(pos, grad=True)
        out, _ = tad.rollout(p, T(vel), T(mass), T(radius), 0.01, n_steps=6,
                             mass_len=ml, remat=remat, backend=backend, **kw)
        (g,) = torch.autograd.grad(torch.sum(out ** 2), p)
        return out.detach(), g

    (p1, g1), (p2, g2) = run(True), run(False)
    assert torch.equal(p1, p2)
    assert torch.equal(g1, g2)


def test_shooting_optimization_converges():
    """Gradient-descend the probe's initial velocity so that it lands near
    a target after 40 steps, as tests/test_autodiff.py does with JAX; the
    first gradient equals JAX's."""
    pos, vel, mass, radius = sun_and_probe()
    loss = tad.trajectory_loss(torch.tensor([80.0, 60.0]), index=1)
    v = T(vel)
    l0 = None
    for k in range(150):
        v = v.detach().requires_grad_()
        lv = loss(T(pos), v, T(mass), T(radius), 0.01, n_steps=40,
                  mass_len=1, remat=False)
        (g,) = torch.autograd.grad(lv, v)
        if l0 is None:
            l0 = float(lv)
            loss_j = jad.trajectory_loss(jnp.array([80.0, 60.0], jnp.float32),
                                         index=1)
            gj = jax.grad(lambda vv: loss_j(
                J(pos), vv, J(mass), J(radius), jnp.float32(0.01), n_steps=40,
                mass_len=1))(J(vel))
            assert rel_err(g.numpy(), gj) < 1e-4
        with torch.no_grad():
            v = v - 0.05 * g
    assert float(lv) < 0.02 * l0, f"loss {float(lv):.3f} vs initial {l0:.3f}"


def test_cuda_backend_is_refused_on_cpu():
    """JAX's "pallas" rollouts run the kernel in interpret mode on the CPU;
    the port's "cuda" needs the card and is refused as World refuses it
    (its parity with "torch" is tests/test_torch_kernels.py's)."""
    pos, vel, mass, radius = sun_and_probe()
    with pytest.raises(ValueError, match="needs a world on a CUDA device"):
        tad.rollout(T(pos), T(vel), T(mass), T(radius), 0.01, n_steps=1,
                    mass_len=1, backend="cuda")
    with pytest.raises(ValueError, match="needs a world on a CUDA device"):
        tad.rollout_sharded(T(pos), T(vel), T(mass), T(radius), 0.01,
                            n_steps=1, mass_len=1, mesh=CPU4, backend="cuda")


def test_rollout_nonaligned_n_matches_jax():
    """N=600, 300 of them massive (tests/test_autodiff.py's non-aligned
    case): value and gradient against JAX's "jnp" and "pallas"."""
    rng = np.random.default_rng(0)
    n = 600
    pos = (100 * rng.normal(size=(n, 2))).astype(np.float32)
    vel = rng.normal(size=(n, 2)).astype(np.float32)
    mass = np.concatenate([rng.uniform(10, 100, 300),
                           np.zeros(300)]).astype(np.float32)
    radius = np.full(n, 1.0, np.float32)

    def lt(s):
        p, _ = tad.rollout(T(pos), s * T(vel), T(mass), T(radius), 0.01,
                           n_steps=3, mass_len=300)
        return torch.sum(p ** 2), p

    s = torch.tensor(1.0, requires_grad=True)
    val, p = lt(s)
    (g,) = torch.autograd.grad(val, s)
    for backend in ("jnp", "pallas"):
        def lj(sc, backend=backend):
            pj, _ = jad.rollout(J(pos), sc * J(vel), J(mass), J(radius),
                                jnp.float32(0.01), n_steps=3, mass_len=300,
                                backend=backend)
            return jnp.sum(pj ** 2), pj

        (vj, pj), gj = jax.value_and_grad(lj, has_aux=True)(jnp.float32(1.0))
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(pj),
                                   rtol=1e-4, atol=1e-3)
        assert float(g) == pytest.approx(float(gj), rel=1e-4)


@pytest.mark.parametrize("backend,grid,tol", [("torch", 64, 3e-5),
                                              ("pm", 128, 1e-5),
                                              ("p3m", 64, 1e-4)])
def test_rollout_value_and_grad_match_jax(backend, grid, tol):
    """The single-device rollout against JAX's on N=500 (seed 4), value and
    gradient, with tests/test_autodiff.py's sharded bounds: pm and p3m
    match JAX only because their box is detached (JAX's stop_gradient).
    p3m's cells hold 32 (the plain pair correction's time on the CPU grows
    with the square of the capacity; 96 would take 5 s a rollout)."""
    (pos, vel, mass, radius), ml = galaxy_state(500, 4)
    jb = {"torch": "jnp"}.get(backend, backend)
    kw = dict(n_steps=3, mass_len=ml, pm_grid=grid)
    if backend == "p3m":
        kw["p3m_cell_capacity"] = 32

    def loss_t(p):
        a, _ = tad.rollout(p, T(vel), T(mass), T(radius), 0.01,
                           backend=backend, **kw)
        return torch.sum(a ** 2)

    def loss_j(p):
        a, _ = jad.rollout(p, J(vel), J(mass), J(radius), jnp.float32(0.01),
                           backend=jb, **kw)
        return jnp.sum(a ** 2)

    v_t, (g_t,) = grad_of(loss_t, pos)
    v_j, g_j = jax.value_and_grad(loss_j)(J(pos))
    assert v_t == pytest.approx(float(v_j), rel=1e-5)
    assert rel_err(g_t, g_j) < tol


def test_sharded_rollout_matches_single_device_and_jax():
    """rollout_sharded on four CPU shards: value and gradient against the
    port's single-device rollout and nbody_tpu's on its 8-device CPU mesh,
    with tests/test_autodiff.py's bounds for the ring (value 1e-5 relative,
    gradient 3e-5); and the values of "pm" and "p3m" against nbody_tpu's
    sharded ones."""
    (pos, vel, mass, radius), ml = galaxy_state(500, 4)
    kw = dict(n_steps=3, mass_len=ml)

    def loss_s(p):
        a, _ = tad.rollout_sharded(p, T(vel), T(mass), T(radius), 0.01,
                                   mesh=CPU4, **kw)
        return torch.sum(a ** 2)

    def loss_1(p):
        a, _ = tad.rollout(p, T(vel), T(mass), T(radius), 0.01, **kw)
        return torch.sum(a ** 2)

    def loss_j(p):
        a, _ = jad.rollout_sharded(p, J(vel), J(mass), J(radius), 0.01,
                                   mesh=jax_mesh(8), **kw)
        return jnp.sum(a ** 2)

    v_s, (g_s,) = grad_of(loss_s, pos)
    v_1, (g_1,) = grad_of(loss_1, pos)
    v_j, g_j = jax.value_and_grad(loss_j)(J(pos))
    assert v_s == pytest.approx(v_1, rel=1e-5)
    assert v_s == pytest.approx(float(v_j), rel=1e-5)
    assert rel_err(g_s, g_1) < 3e-5
    assert rel_err(g_s, g_j) < 3e-5
    # "pm" and "p3m" (ROADMAP A8), which raised before: the value against
    # nbody_tpu's sharded rollout (gradients in
    # tests/test_torch_sharded_mesh.py)
    for backend in ("pm", "p3m"):
        mesh_kw = dict(kw, backend=backend, pm_grid=128,
                       p3m_cell_capacity=32)
        a_t, _ = tad.rollout_sharded(T(pos), T(vel), T(mass), T(radius), 0.01,
                                     mesh=CPU4, **mesh_kw)
        a_j, _ = jad.rollout_sharded(J(pos), J(vel), J(mass), J(radius), 0.01,
                                     mesh=jax_mesh(8), **mesh_kw)
        assert torch.sum(a_t ** 2).item() == pytest.approx(
            float(jnp.sum(a_j ** 2)), rel=1e-5)


def test_sharded_gradient_conditioning():
    """On two galaxies the gradient of sum(pos²) with respect to pos0 is a
    small remainder of large terms that cancel at each galaxy core, so two
    summation orders (the ring's per-hop sums, one sum) give it different
    low bits: nbody_tpu's own sharded and single-device rollouts differ
    there by more than 3e-5 of its max, and the port's by no more than
    nbody_tpu's. A loss on one tracer is well conditioned: both agree to
    3e-5 (chip_smoke.py [17] gates that one on the card)."""
    (pos, vel, mass, radius), ml = galaxy_state(600, 11037, galaxies=2)
    kw = dict(n_steps=3, mass_len=ml)
    tracer = ml + 5
    target = pos[tracer] + 5.0

    def losses_t(a):
        return (torch.sum(a ** 2),
                torch.sum((a[tracer] - torch.from_numpy(target)) ** 2))

    def grads_t(sharded):
        p = T(pos, grad=True)
        if sharded:
            a, _ = tad.rollout_sharded(p, T(vel), T(mass), T(radius), 0.01,
                                       mesh=CPU4, **kw)
        else:
            a, _ = tad.rollout(p, T(vel), T(mass), T(radius), 0.01, **kw)
        return [torch.autograd.grad(v, p, retain_graph=True)[0].numpy()
                for v in losses_t(a)]

    def loss_j(p, sharded, which):
        if sharded:
            a, _ = jad.rollout_sharded(p, J(vel), J(mass), J(radius), 0.01,
                                       mesh=jax_mesh(4), **kw)
        else:
            a, _ = jad.rollout(p, J(vel), J(mass), J(radius),
                               jnp.float32(0.01), **kw)
        return (jnp.sum(a ** 2) if which == 0
                else jnp.sum((a[tracer] - J(target)) ** 2))

    g_s, g_1 = grads_t(True), grads_t(False)
    jax_gap = rel_err(jax.grad(lambda p: loss_j(p, True, 0))(J(pos)),
                      jax.grad(lambda p: loss_j(p, False, 0))(J(pos)))
    assert jax_gap > 3e-5
    assert rel_err(g_s[0], g_1[0]) <= jax_gap
    assert rel_err(g_s[1], g_1[1]) < 3e-5


def test_sharded_tracer_gradient_without_its_row():
    """Over one step, the gradient of a tracer's loss has, in every row but
    the tracer's own (which is about 2(p − target) and dominates max|ref|),
    one pair's term of the tracer's force, reached only through the ring's
    backward: the port's sharded rollout matches its single-device one and
    nbody_tpu's sharded one there within 3e-5 of those rows' max."""
    (pos, vel, mass, radius), ml = galaxy_state(600, 11037, galaxies=2)
    kw = dict(n_steps=1, mass_len=ml)
    tracer = ml + 5
    target = pos[tracer] + 5.0
    off = np.arange(pos.shape[0]) != tracer

    def loss_t(sharded):
        def loss(p):
            if sharded:
                a, _ = tad.rollout_sharded(p, T(vel), T(mass), T(radius),
                                           0.01, mesh=CPU4, **kw)
            else:
                a, _ = tad.rollout(p, T(vel), T(mass), T(radius), 0.01, **kw)
            return torch.sum((a[tracer] - torch.from_numpy(target)) ** 2)
        return loss

    def loss_j(p):
        a, _ = jad.rollout_sharded(p, J(vel), J(mass), J(radius), 0.01,
                                   mesh=jax_mesh(4), **kw)
        return jnp.sum((a[tracer] - J(target)) ** 2)

    _, (g_s,) = grad_of(loss_t(True), pos)
    _, (g_1,) = grad_of(loss_t(False), pos)
    g_j = np.asarray(jax.grad(loss_j)(J(pos)))
    assert np.abs(g_1[off]).max() > 0
    assert rel_err(g_s[off], g_1[off]) < 3e-5
    assert rel_err(g_s[off], g_j[off]) < 3e-5


def test_sharded_rollout_nonaligned_large_shard():
    """N=1300 on two shards (the shard size is no multiple of anything):
    against the single-device rollout and JAX's 2-device one."""
    (pos, vel, mass, radius), ml = galaxy_state(1300, 8)
    ps, _ = tad.rollout_sharded(T(pos), T(vel), T(mass), T(radius), 0.01,
                                n_steps=3, mass_len=ml, mesh=["cpu"] * 2)
    p1, _ = tad.rollout(T(pos), T(vel), T(mass), T(radius), 0.01, n_steps=3,
                        mass_len=ml)
    pj, _ = jad.rollout_sharded(J(pos), J(vel), J(mass), J(radius), 0.01,
                                n_steps=3, mass_len=ml, mesh=jax_mesh(2))
    scale = float(p1.abs().max())
    np.testing.assert_allclose(ps.numpy() / scale, p1.numpy() / scale,
                               atol=1e-6)
    np.testing.assert_allclose(ps.numpy() / scale, np.asarray(pj) / scale,
                               atol=1e-6)


def test_p3m_rollout_rebin_value_and_grad_parity():
    """p3m_rebin_interval (tests/test_autodiff.py): the frozen-bins rollout
    tracks the rebuild-every-step one in value and gradient, and rebin=1 is
    World.update's p3m trajectory (the p3m gradient against JAX's is
    test_rollout_value_and_grad_match_jax's)."""
    (pos, vel, mass, radius), ml = galaxy_state(700, 6)
    kw = dict(n_steps=12, mass_len=ml, pm_grid=128, p3m_cell_capacity=32,
              p3m_exact_targets=16, precise=False, backend="p3m")

    def loss_t(rebin):
        def f(p):
            a, _ = tad.rollout(p, T(vel), T(mass), T(radius), 0.01,
                               p3m_rebin_interval=rebin, **kw)
            return torch.sum(a * a) * 1e-6
        return grad_of(f, pos)

    (v1, (g1,)), (v4, (g4,)) = loss_t(1), loss_t(4)
    np.testing.assert_allclose(v4, v1, rtol=1e-4)
    scale = np.abs(g1).max()
    np.testing.assert_allclose(g4 / scale, g1 / scale, atol=6e-3)
    assert np.percentile(np.abs(g4 - g1) / scale, 99) < 1e-3


    p1, _ = tad.rollout(T(pos), T(vel), T(mass), T(radius), 0.01,
                        p3m_rebin_interval=1, **kw)
    cfg = nt.SimConfig(pm_grid=128, p3m_cell_capacity=32, p3m_exact_targets=16)
    w2 = nt.create_world(nt.make_particles(pos, vel=vel, mass=mass,
                                           radius=radius),
                         config=cfg, device="cpu")
    w2.update(0.01, 12, backend="p3m")
    ref = w2.particles.pos.numpy()
    s = np.abs(ref).max()
    np.testing.assert_allclose(p1.detach().numpy() / s, ref / s, atol=1e-6)


def test_pp_chunk_mass_gradient_semantics():
    """Half (a) of tests/test_autodiff.py's case: the gradient of p3m_acc
    with respect to an exactly massless source's gm matches a central
    finite difference and JAX's unchunked gradient. The port has no chunk
    skip, so half (b) cannot happen: a rollout's mass gradient with
    p3m_pp_chunk=16 is its unchunked one, bit for bit."""
    tgt_pos = np.array([[0.0, 0.0], [1000.0, 1000.0]], np.float32)
    tgt_radius = np.array([0.5, 10.0], np.float32)
    src_pos = np.array([[1.0, 0.0], [1000.0, 1000.0], [980.0, 1010.0],
                        [1010.0, 985.0]], np.float32)
    src_gm = np.array([0.0, 10.0, 10.0, 10.0], np.float32)
    kw = dict(grid=64, rc_cells=4, cell_capacity=8, exact_targets=1)

    def loss_t(gm):
        return tp3m.p3m_acc(T(tgt_pos), T(tgt_radius), T(src_pos), gm,
                            **kw)[0, 0]

    gm = T(src_gm, grad=True)
    (g_t,) = torch.autograd.grad(loss_t(gm), gm)
    eps = 1e-2
    e0 = np.zeros(4, np.float32)
    e0[0] = eps
    with torch.no_grad():
        fd = (float(loss_t(T(src_gm + e0))) - float(loss_t(T(src_gm - e0)))) \
            / (2 * eps)
    np.testing.assert_allclose(g_t[0], fd, rtol=5e-2)
    assert abs(g_t[0]) > 0.3
    from nbody_tpu.ops.p3m_forces import p3m_acc as jp3m
    g_j = jax.grad(lambda g: jp3m(J(tgt_pos), J(tgt_radius), J(src_pos), g,
                                  **kw, pp_chunk=None)[0, 0])(J(src_gm))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-4)

    (pos, vel, mass, radius), ml = galaxy_state(300, 5)

    def mass_grad(chunk):
        m = T(mass, grad=True)
        a, _ = tad.rollout(T(pos), T(vel), m, T(radius), 0.01, n_steps=1,
                           mass_len=ml, backend="p3m", pm_grid=64,
                           p3m_cell_capacity=16, p3m_pp_chunk=chunk)
        return torch.autograd.grad(torch.sum(a ** 2), m)[0]

    assert torch.equal(mass_grad(16), mass_grad(0))


def test_rollout_particles_wrapper():
    (pos, vel, mass, radius), ml = galaxy_state(300, 4)
    h = nt.make_particles(pos, vel=vel, mass=mass, radius=radius)
    out = tad.rollout_particles(h, 0.01, n_steps=6, mass_len=ml)
    assert isinstance(out, nt.Particles)
    assert not torch.allclose(out.pos, h.pos)
    assert torch.equal(out.mass, h.mass)
    assert torch.equal(out.radius, h.radius)
    w = nt.create_world(h, config=nt.SimConfig(precise=True), device="cpu")
    w.update(0.01, 6, backend="torch")
    ref = w.particles.pos.numpy()
    s = np.abs(ref).max()
    np.testing.assert_allclose(out.pos.numpy() / s, ref / s, atol=1e-6)


def test_unknown_backend_raises():
    """A name that neither package takes is refused by both, with JAX's
    message; the port's own names are listed."""
    pos, vel, mass, radius = sun_and_probe()
    for mod, arr in ((tad, T), (jad, J)):
        with pytest.raises(ValueError, match="unknown rollout backend"):
            mod.rollout(arr(pos), arr(vel), arr(mass), arr(radius), 0.01,
                        n_steps=1, mass_len=1, backend="cuda_ring")
    with pytest.raises(ValueError, match="'torch', 'cuda', 'pm', 'p3m'"):
        tad.rollout(T(pos), T(vel), T(mass), T(radius), 0.01, n_steps=1,
                    mass_len=1, backend="jnp")
    with pytest.raises(ValueError, match="unknown sharded rollout backend"):
        tad.rollout_sharded(T(pos), T(vel), T(mass), T(radius), 0.01,
                            n_steps=1, mass_len=1, mesh=CPU4,
                            backend="pallas_ring")
    with pytest.raises(ValueError, match="unknown sharded rollout backend"):
        jad.rollout_sharded(J(pos), J(vel), J(mass), J(radius), 0.01,
                            n_steps=1, mass_len=1, mesh=jax_mesh(),
                            backend="pallas_ring")


# -- hooks and integrators: tests/test_extra_force.py, test_integrators.py -

def _uniform_field(pos, vel):
    return 0.0 * pos - 9.8


def test_rollout_hook_matches_world_and_jax():
    (pos, vel, mass, radius), ml = galaxy_state(250, 3)
    p, _ = tad.rollout(T(pos), T(vel), T(mass), T(radius), DT, n_steps=5,
                       mass_len=ml, precise=False, extra_force=_uniform_field)
    w = nt.create_world(nt.make_particles(pos, vel=vel, mass=mass,
                                          radius=radius), device="cpu")
    w.update(DT, 5, backend="torch", extra_force=_uniform_field)
    assert torch.equal(p, w.particles.pos)
    pj, _ = jad.rollout(J(pos), J(vel), J(mass), J(radius), jnp.float32(DT),
                        n_steps=5, mass_len=ml, precise=False,
                        extra_force=_uniform_field)
    np.testing.assert_allclose(p.numpy(), np.asarray(pj), rtol=2e-4,
                               atol=2e-3)


def _thrust_t(pos, vel, theta):
    return theta.expand(pos.shape)


def _thrust_j(pos, vel, theta):
    return jnp.broadcast_to(theta, pos.shape)


@pytest.mark.parametrize("sharded", [False, True])
def test_rollout_grad_reaches_control_params(sharded):
    """Closed form: under semi-implicit Euler with constant acceleration
    theta, d(x_n)/d(theta) = dt² n(n+1)/2; JAX's gradient agrees."""
    n = 7
    zeros = np.zeros((1, 2), np.float32)
    one = (T(zeros), T(zeros), torch.zeros(1), torch.ones(1))

    def final_x(theta):
        if sharded:
            pos, _ = tad.rollout_sharded(*one, DT, n_steps=n, mass_len=0,
                                         mesh=CPU4, precise=False,
                                         extra_force=_thrust_t,
                                         extra_force_params=theta)
        else:
            pos, _ = tad.rollout(*one, DT, n_steps=n, mass_len=0,
                                 precise=False, extra_force=_thrust_t,
                                 extra_force_params=theta)
        return pos[0, 0]

    theta = torch.tensor([0.3, 0.0], requires_grad=True)
    (g,) = torch.autograd.grad(final_x(theta), theta)
    expect = DT * DT * n * (n + 1) / 2
    assert float(g[0]) == pytest.approx(expect, rel=1e-5)
    assert float(g[1]) == 0.0
    jone = (J(zeros), J(zeros), jnp.zeros(1), jnp.ones(1))
    gj = jax.grad(lambda th: jad.rollout(
        *jone, jnp.float32(DT), n_steps=n, mass_len=0, precise=False,
        extra_force=_thrust_j, extra_force_params=th)[0][0, 0])(
            jnp.asarray([0.3, 0.0], jnp.float32))
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=1e-5)


def test_sharded_rollout_hook_matches_single_and_jax():
    (pos, vel, mass, radius), ml = galaxy_state(256, 11)
    k0 = torch.tensor(0.07, requires_grad=True)

    def drag(pos_, vel_, k):
        return -k * vel_

    args = (T(pos), T(vel), T(mass), T(radius), DT)
    kw = dict(n_steps=5, mass_len=ml, precise=False, extra_force=drag,
              extra_force_params=k0)
    ref, _ = tad.rollout(*args, **kw)
    got, _ = tad.rollout_sharded(*args, mesh=CPU4, **kw)
    scale = float(ref.abs().max())
    np.testing.assert_allclose(got.detach().numpy() / scale,
                               ref.detach().numpy() / scale, atol=3e-5)
    (g_s,) = torch.autograd.grad(torch.sum(got ** 2), k0)
    (g_1,) = torch.autograd.grad(torch.sum(ref ** 2), k0)
    pj, _ = jad.rollout_sharded(J(pos), J(vel), J(mass), J(radius),
                                jnp.float32(DT), n_steps=5, mass_len=ml,
                                mesh=jax_mesh(4), precise=False,
                                extra_force=drag,
                                extra_force_params=jnp.float32(0.07))
    np.testing.assert_allclose(got.detach().numpy() / scale,
                               np.asarray(pj) / scale, atol=3e-5)
    assert float(g_s) == pytest.approx(float(g_1), rel=1e-4)


def test_wrong_shape_hook_raises_in_rollouts():
    (pos, vel, mass, radius), ml = galaxy_state(200, 1)
    args = (T(pos), T(vel), T(mass), T(radius), DT)
    with pytest.raises(ValueError, match="extra_force must return"):
        tad.rollout(*args, n_steps=1, mass_len=ml,
                    extra_force=lambda p_, v_: v_[:, 0])
    with pytest.raises(ValueError, match="extra_force must return"):
        tad.rollout_sharded(*args, n_steps=1, mass_len=ml, mesh=CPU4,
                            extra_force=lambda p_, v_: v_[:, :1])


@pytest.mark.parametrize("integrator", ["leapfrog", "yoshida4"])
def test_rollout_integrators_match_world_and_jax(integrator):
    """rollout(integrator=...) primal == the World's trajectory, and its
    gradient through the composition (the negative middle stage of
    yoshida4 included) equals JAX's."""
    (pos, vel, mass, radius), ml = galaxy_state(120, 2)
    kw = dict(n_steps=4, mass_len=ml, precise=True, integrator=integrator)

    def loss_t(v0):
        p, _ = tad.rollout(T(pos), v0, T(mass), T(radius), DT, **kw)
        return torch.sum(p ** 2), p

    v0 = T(vel, grad=True)
    val, p = loss_t(v0)
    (g,) = torch.autograd.grad(val, v0)
    w = nt.create_world(nt.make_particles(pos, vel=vel, mass=mass,
                                          radius=radius),
                        config=nt.SimConfig(integrator=integrator,
                                            precise=True), device="cpu")
    w.update(DT, 4, backend="torch")
    assert torch.equal(p.detach(), w.particles.pos)
    gj = jax.grad(lambda vv: jnp.sum(jad.rollout(
        J(pos), vv, J(mass), J(radius), jnp.float32(DT), **kw)[0] ** 2))(
            J(vel))
    assert np.isfinite(g.numpy()).all()
    assert rel_err(g.numpy(), gj) < 1e-5


def test_rollout_dt_mass_radius_gradients_match_jax():
    """The gradient reaches dt, mass and radius as JAX's does."""
    (pos, vel, mass, radius), ml = galaxy_state(150, 7)
    loss_t = tad.trajectory_loss(torch.tensor([0.0, 0.0]), index=ml + 3)
    loss_j = jad.trajectory_loss(jnp.zeros(2, jnp.float32), index=ml + 3)
    kw = dict(n_steps=5, mass_len=ml)
    _, grads = grad_of(lambda m, r, dt: loss_t(T(pos), T(vel), m, r, dt, **kw),
                       mass, radius, np.float32(DT))
    gj = jax.grad(lambda m, r, dt: loss_j(J(pos), J(vel), m, r, dt, **kw),
                  argnums=(0, 1, 2))(J(mass), J(radius), jnp.float32(DT))
    for got, want in zip(grads, gj):
        assert np.isfinite(got).all()
        assert rel_err(got, want) < 1e-4


# -- the VJPs ---------------------------------------------------------------

def _vjp_inputs(t, s, seed, prefix=False):
    """(tgt_pos, tgt_radius, src_pos, src_gm, g) numpy: a third of the
    sources have gm = 0, half the targets radius 0. The sources lie apart
    from the targets, or with ``prefix`` are the first s targets (as the
    rollout passes p[:m]; radii then positive, so that no target sits on
    itself at r2 = 1e-18)."""
    rng = np.random.default_rng(seed)
    tp = (100 * rng.normal(size=(t, 2))).astype(np.float32)
    tr = rng.uniform(0.5, 5, t).astype(np.float32)
    if prefix:
        sp = tp[:s].copy()
    else:
        tr[::2] = 0.0
        sp = (100 * rng.normal(size=(s, 2))).astype(np.float32)
    sg = rng.uniform(1, 100, s).astype(np.float32)
    sg[::3] = 0.0
    g = rng.normal(size=(t, 2)).astype(np.float32)
    return tp, tr, sp, sg, g


@pytest.mark.parametrize("precise", [True, False])
@pytest.mark.parametrize("t,s,prefix", [(300, 117, False), (300, 0, False),
                                        (64, 500, False), (257, 257, True),
                                        (300, 117, True)])
def test_force_acc_vjp_plain_matches_jax(precise, t, s, prefix):
    tp, tr, sp, sg, g = _vjp_inputs(t, s, seed=t + s, prefix=prefix)
    got = df.force_acc_vjp_plain(T(tp), T(tr), T(sp), T(sg), T(g),
                                 precise=precise)
    _, vjp = jax.vjp(lambda *a: jforces.direct_sum_acc(*a, precise=precise),
                     J(tp), J(tr), J(sp), J(sg))
    want = vjp(J(g))
    for name, a, b in zip(("tgt_pos", "tgt_radius", "src_pos", "src_gm"),
                          got, want):
        b = np.asarray(b)
        assert a.shape == b.shape
        if b.size == 0 or not np.abs(b).max():
            assert not a.abs().sum(), name
            continue
        assert rel_err(a.numpy(), b) < TOL_VJP, name


def test_force_acc_vjp_small_chunks_and_autograd():
    """The plain VJP gives the same cotangents chunk by chunk (summed over
    target chunks in order) within fp32 rounding, and force_acc's backward
    is force_acc_vjp."""
    tp, tr, sp, sg, g = _vjp_inputs(200, 90, seed=1, prefix=True)
    whole = df.force_acc_vjp_plain(T(tp), T(tr), T(sp), T(sg), T(g))
    parts = df.force_acc_vjp_plain(T(tp), T(tr), T(sp), T(sg), T(g), chunk=7)
    for a, b in zip(parts, whole):
        assert rel_err(a.numpy(), b.numpy()) < 1e-6
    ts = [T(a, grad=True) for a in (tp, tr, sp, sg)]
    df.force_acc(*ts).backward(T(g))
    for t_, want in zip(ts, whole):
        assert torch.equal(t_.grad, want)


@pytest.mark.parametrize("t,s", [(65536, 32833), (64, 524704), (1000, 333),
                                 (1, 1), (257, 1), (300, 2000), (70000, 900),
                                 (900, 70000), (4096, 4096), (700, 900)])
@pytest.mark.parametrize("sms", [1, 132])
def test_vjp_plan_depends_on_shapes_alone_and_covers_every_pair(t, s, sms):
    """The VJP kernel's plan (csrc/direct_vjp.cu) comes from (T, S, SMs)
    alone, so a recomputed backward repeats its bits; its blocks' own-row
    tiles and other-row ranges are non-empty, contiguous and cover both
    sides, so each pair lies in exactly one block; the own side is the
    larger; about one wave of blocks where the tiles alone are fewer."""
    plan = df.vjp_plan(t, s, sms)
    assert plan == df.vjp_plan(t, s, sms)
    n_own, n_other = (t, s) if plan.own == "targets" else (s, t)
    assert n_own >= n_other
    blocks = df.vjp_blocks(t, s, plan)
    tiles = sorted({own for own, _ in blocks})
    ranges = sorted({other for _, other in blocks})
    assert len(blocks) == len(tiles) * len(ranges) == len(set(blocks))
    for spans, n in ((tiles, n_own), (ranges, n_other)):
        assert spans[0][0] == 0 and spans[-1][1] == n
        assert all(a < b for a, b in spans)
        assert all(x[1] == y[0] for x, y in zip(spans, spans[1:]))
    assert len(ranges) == plan.n_split
    assert all(b - a <= plan.runs_per_split * df.RUN for a, b in ranges)
    if len(tiles) < df.VJP_BLOCKS_PER_SM * sms:
        assert len(blocks) <= df.VJP_BLOCKS_PER_SM * sms or plan.n_split == 1


def test_force_acc_vjp_zero_radius_trap():
    """A zero-radius target on a gm = 0 source at its own position: the
    port's cotangents are finite, 0 from that pair, and equal JAX's rsqrt
    VJP; JAX's precise VJP is NaN there (0 · inf)."""
    tp = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    tr = np.zeros(2, np.float32)
    sp = np.array([[1.0, 2.0], [5.0, 5.0]], np.float32)
    sg = np.zeros(2, np.float32)
    g = np.ones((2, 2), np.float32)
    _, vjp = jax.vjp(lambda *a: jforces.direct_sum_acc(*a, precise=False),
                     J(tp), J(tr), J(sp), J(sg))
    want = [np.asarray(x) for x in vjp(J(g))]
    for precise in (True, False):
        got = df.force_acc_vjp_plain(T(tp), T(tr), T(sp), T(sg), T(g),
                                     precise=precise)
        for a, b in zip(got, want):
            assert torch.isfinite(a).all()
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6)
    assert not got[0].abs().max() and not got[1].abs().max()


def _cell_rows_case(seed, gc=6, cap=8, rc=9.0, cell=10.0):
    """Cell-sorted rows of a gc×gc grid: counts up to cap + 3 (cells past
    the cap), an empty target and an empty source cell, a third of the
    targets of radius 0, and self pairs (a source on a target of positive
    radius in the same cell). Returns the rows and runs (numpy) and the
    JAX blocks of their first cap rows."""
    rng = np.random.default_rng(seed)
    n_cells = gc * gc
    counts_t = rng.integers(0, cap + 4, n_cells).astype(np.int32)
    counts_s = rng.integers(0, cap + 4, n_cells).astype(np.int32)
    counts_t[3] = 0
    counts_s[5] = 0

    def rows(counts, third):
        out = []
        for c, n in enumerate(counts):
            ij = np.array(divmod(c, gc), np.float64)
            xy = (ij + rng.uniform(0, 1, (n, 2))) * cell
            out.append(np.concatenate([xy, third(n)[:, None],
                                       np.zeros((n, 1))], 1))
        return np.concatenate(out).astype(np.float32)

    trows = rows(counts_t, lambda n: rng.uniform(0, 2, n)
                 * (rng.uniform(size=n) > 0.3))
    srows = rows(counts_s, lambda n: rng.uniform(0.5, 5, n))
    st = (np.cumsum(counts_t) - counts_t).astype(np.int32)
    ss = (np.cumsum(counts_s) - counts_s).astype(np.int32)
    for c in range(n_cells):
        if counts_t[c] and counts_s[c] and trows[st[c], 2] > 0:
            srows[ss[c], :2] = trows[st[c], :2]
    g = rng.normal(size=(trows.shape[0], 2)).astype(np.float32)

    def blocks(r, start, counts, fill):
        b = np.tile(np.asarray(fill, np.float32), (n_cells, cap, 1))
        for c in range(n_cells):
            k = min(counts[c], cap)
            b[c, :k] = r[start[c]:start[c] + k]
        return b

    jb = dict(tb=blocks(trows, st, counts_t, (0, 0, 1, 0)),
              sb=blocks(srows, ss, counts_s, (0, 0, 0, 0)),
              gb=blocks(np.concatenate([g, np.zeros_like(g)], 1), st,
                        counts_t, (0, 0, 0, 0)))
    trows[:, 2] += FLOOR
    return dict(trows=trows, srows=srows, st=st, ct=counts_t, ss=ss,
                cs=counts_s, g=g, gc=gc, cap=cap, rc=rc, eps2=4.0, **jb)


def _blocks_to_rows(grads, start, counts, cap, n):
    d = np.zeros((n, 3), np.float32)
    for c in range(len(counts)):
        k = min(counts[c], cap)
        for q in range(3):
            d[start[c]:start[c] + k, q] = grads[q][c, :k]
    return d


@pytest.mark.parametrize("precise", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_pp_cells_vjp_plain_matches_jax(precise, seed):
    """pp_cells_vjp_plain against jax.vjp of _pp_blocks_jnp (through
    nbody_tpu's pp_blocks, its floor added outside) on the same slots:
    rows past a cell's cap get exactly 0 on both sides."""
    c = _cell_rows_case(seed)
    gc, cap = c["gc"], c["cap"]
    args = [J(c[b][..., k].reshape(gc, gc, cap)) for b in ("tb", "sb")
            for k in range(3)]
    _, vjp = jax.vjp(lambda *a: p3m_pallas._pp_blocks_jnp(
        a[0], a[1], a[2] + FLOOR, *a[3:], c["rc"], c["eps2"],
        precise=precise), *args)
    jg = [np.asarray(x).reshape(gc * gc, cap) for x in vjp(J(c["gb"][..., :2]))]
    want_t = _blocks_to_rows(jg[:3], c["st"], c["ct"], cap, len(c["trows"]))
    want_s = _blocks_to_rows(jg[3:], c["ss"], c["cs"], cap, len(c["srows"]))
    d_t, d_s = pp.pp_cells_vjp(
        T(c["trows"]), T(c["srows"]), torch.tensor(c["st"]),
        torch.tensor(c["ct"]), torch.tensor(c["ss"]), torch.tensor(c["cs"]),
        c["rc"], c["eps2"], T(c["g"]), cap_t=cap, cap_s=cap, precise=precise)
    assert not d_t[:, 3].abs().max() and not d_s[:, 3].abs().max()
    for got, want in ((d_t, want_t), (d_s, want_s)):
        for q in range(3):
            assert rel_err(got[:, q].numpy(), want[:, q]) < TOL_VJP
        over = np.all(want == 0, axis=1)
        assert not got[over].abs().max()


def test_pp_cells_autograd_is_vjp_and_cells_subset():
    """pp_cells' backward is pp_cells_vjp; the ``cells`` judge computes the
    rows of the cells it names and leaves the others 0."""
    c = _cell_rows_case(2)
    runs = [torch.tensor(c[k]) for k in ("st", "ct", "ss", "cs")]
    kw = dict(cap_t=c["cap"], cap_s=c["cap"])
    tr, sr = T(c["trows"], grad=True), T(c["srows"], grad=True)
    pp.pp_cells(tr, sr, *runs, c["rc"], c["eps2"], **kw).backward(T(c["g"]))
    d_t, d_s = pp.pp_cells_vjp(T(c["trows"]), T(c["srows"]), *runs, c["rc"],
                               c["eps2"], T(c["g"]), **kw)
    assert torch.equal(tr.grad, d_t) and torch.equal(sr.grad, d_s)
    cells = torch.tensor([0, 7, 14, 20])
    p_t, p_s = pp.pp_cells_vjp_plain(T(c["trows"]), T(c["srows"]), *runs,
                                     c["rc"], c["eps2"], T(c["g"]),
                                     cells=cells, **kw)
    for part, whole, st, ct in ((p_t, d_t, c["st"], c["ct"]),
                                (p_s, d_s, c["ss"], c["cs"])):
        mine = np.zeros(len(whole), bool)
        for cc in cells.tolist():
            mine[st[cc]:st[cc] + min(ct[cc], c["cap"])] = True
        assert torch.allclose(part[mine], whole[mine], rtol=1e-6, atol=1e-9)
        assert not part[~mine].abs().max()


@pytest.mark.parametrize("rows", [8, 64, 256])
def test_pp_vjp_plan_depends_on_counts_alone_and_covers_every_pair(rows):
    """The plan of K4's VJP kernel (csrc/p3m_pp_vjp.cu), built by the
    wrapper's own torch code, on a 7×7 grid with empty cells on both
    sides, cells past the caps, the border, and a dense cell whose
    neighbourhood the ranges cut: it reads only min(counts, cap); every
    (live target, live neighbour source) pair lies in exactly one task
    and range, each range of at most R rows; every (source row, target
    cell) partial slot that the sums read is written exactly once, and no
    other; every (target row, range) once; the heavy cells' tasks first;
    the sums' tiles cover the rows they add up once each."""
    gc, cap_t, cap_s = 7, 200, 40
    rng = np.random.default_rng(rows)
    counts_t = rng.integers(0, 45, gc * gc).astype(np.int32)
    counts_s = rng.integers(0, 60, gc * gc).astype(np.int32)
    counts_t[[0, 10]] = 0
    counts_s[[3, 10]] = 0
    counts_t[24], counts_s[24] = 150, 75            # dense, past cap_s
    counts_s[[16, 17, 18, 23, 25, 30, 31, 32]] = 50  # 9 · cap_s around it
    counts_t[47], counts_s[47] = 260, 41            # past both caps, border
    plan = pp.vjp_plan(torch.tensor(counts_t), torch.tensor(counts_s), gc,
                       cap_t, cap_s, rows)
    more = [np.where(c > cap, c + 9, c) for c, cap in ((counts_t, cap_t),
                                                       (counts_s, cap_s))]
    again = pp.vjp_plan(*(torch.tensor(c) for c in more), gc, cap_t, cap_s,
                        rows)
    assert all(torch.equal(a, b) for a, b in zip(plan[:2], again[:2]))
    assert plan.k_max == -(-9 * cap_s // rows)
    live_t = np.minimum(counts_t, cap_t)
    live_s = np.minimum(counts_s, cap_s)
    start_s = np.cumsum(counts_s) - counts_s
    staged = np.zeros((gc * gc, counts_s.sum()), np.int64)  # (cell, row)
    slots = np.zeros((counts_s.sum(), 9), np.int64)
    seen = np.zeros((gc * gc, plan.k_max), np.int64)
    tasks = pp.vjp_tasks(plan, torch.tensor(counts_s), gc, cap_s)
    assert len(tasks) == int(plan.ranges.sum())
    heavy = [live_t[c] > 3 * pp.TILE for c, _, _ in tasks]
    assert heavy == sorted(heavy, reverse=True) and heavy[0]
    for cell, r, spans in tasks:
        assert live_t[cell] > 0
        assert 0 < sum(b - a for _, a, b, _ in spans) <= rows
        seen[cell, r] += 1
        for nc, a, b, slot in spans:
            assert abs(nc // gc - cell // gc) <= 1 >= abs(nc % gc - cell % gc)
            assert slot == (cell // gc - nc // gc + 1) * 3 + cell % gc - nc % gc + 1
            assert 0 <= a < b <= live_s[nc]
            staged[cell, start_s[nc] + a:start_s[nc] + b] += 1
            slots[start_s[nc] + a:start_s[nc] + b, slot] += 1
    assert plan.ranges.max() > 1
    for c in range(gc * gc):
        assert (seen[c, :plan.ranges[c]] == 1).all()
        assert not seen[c, plan.ranges[c]:].any()
        ci, cj = divmod(c, gc)
        for nc in range(gc * gc):
            near = abs(nc // gc - ci) <= 1 and abs(nc % gc - cj) <= 1
            rows_nc = slice(start_s[nc], start_s[nc] + counts_s[nc])
            want = np.zeros(counts_s[nc], np.int64)
            if near and live_t[c] > 0:
                want[:live_s[nc]] = 1
            np.testing.assert_array_equal(staged[c, rows_nc], want)
    # the slots the sum kernel reads: target cells in the grid with targets
    for sc in range(gc * gc):
        si, sj = divmod(sc, gc)
        for d in range(9):
            ti, tj = si + d // 3 - 1, sj + d % 3 - 1
            read = 0 <= ti < gc and 0 <= tj < gc and live_t[ti * gc + tj] > 0
            want = np.zeros(counts_s[sc], np.int64)
            want[:live_s[sc]] = int(read)
            np.testing.assert_array_equal(
                slots[start_s[sc]:start_s[sc] + counts_s[sc], d], want)
    # the sums' tiles: every live source row once, every live target row
    # of a cell of more than one range once
    summed = {"sources": np.zeros((gc * gc, cap_s), np.int64),
              "targets": np.zeros((gc * gc, cap_t), np.int64)}
    for side, cell, q in pp.vjp_sum_tiles(plan):
        live = (live_s if side == "sources" else live_t)[cell]
        assert q < live     # the kernel masks the slots past live
        summed[side][cell, q:min(q + pp.TILE, live)] += 1
    ranges = plan.ranges.numpy()
    for side, live in (("sources", live_s),
                       ("targets", np.where(ranges > 1, live_t, 0))):
        want = np.arange(summed[side].shape[1]) < live[:, None]
        np.testing.assert_array_equal(summed[side] > 0, want)
        assert summed[side].max() == 1
    n_t, n_s = int(counts_t.sum()), int(counts_s.sum())
    assert pp.vjp_scratch_bytes(n_t, n_s, plan) == \
        12 * ((plan.k_max - 1) * n_t + 9 * n_s)


# -- the pieces under them ---------------------------------------------------

def test_sqrt_gradient_is_jax_bit_for_bit():
    x = np.random.default_rng(0).uniform(1e-6, 1e3, 4096).astype(np.float32)
    t = T(x, grad=True)
    tforces.sqrt(t).backward(torch.ones_like(t))
    want = jax.grad(lambda a: jnp.sum(jnp.sqrt(a)))(J(x))
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))
    assert np.array_equal(tforces.sqrt(T(x)).numpy(), np.sqrt(x))


def test_cell_rows_gradient_is_the_inverse_permutation():
    rng = np.random.default_rng(3)
    n = 50
    xy, w = T(rng.normal(size=(n, 2)), grad=True), T(rng.normal(size=n),
                                                     grad=True)
    order = torch.from_numpy(rng.permutation(n))
    rows = tp3m._cell_rows(xy, w, order)
    assert torch.equal(rows[:, :2], xy.detach()[order])
    g = T(rng.normal(size=(n, 4)))
    rows.backward(g)
    inv = torch.argsort(order)
    assert torch.equal(xy.grad, g[inv, :2])
    assert torch.equal(w.grad, g[inv, 2])


def test_add_at_passes_gradients_to_src():
    rng = np.random.default_rng(4)
    index = torch.from_numpy(rng.integers(0, 10, 40))
    for shape in ((40,), (40, 2)):
        src = T(rng.normal(size=shape), grad=True)
        dst = torch.zeros((10,) + shape[1:])
        tforces.add_at(dst, index, src)
        g = T(rng.normal(size=dst.shape))
        dst.backward(g)
        assert torch.equal(src.grad, g[index])


def test_rollout_values_unchanged_by_grad_mode():
    """Every forward keeps its bits under autograd: a rollout with inputs
    that require grad gives the no-grad rollout's values."""
    (pos, vel, mass, radius), ml = galaxy_state(200, 9)
    for backend in ("torch", "pm", "p3m"):
        kw = dict(n_steps=3, mass_len=ml, backend=backend, pm_grid=64)
        with torch.no_grad():
            want, _ = tad.rollout(T(pos), T(vel), T(mass), T(radius), DT, **kw)
        got, _ = tad.rollout(T(pos, grad=True), T(vel), T(mass, grad=True),
                             T(radius, grad=True), DT, **kw)
        assert torch.equal(got.detach(), want), backend


def test_random_arrays_vjp_through_world_force():
    """The "torch" World force of random arrays (massless tracers of
    radius 0.5, tests/helpers.py's mix) differentiates to JAX's VJP."""
    pos, _, mass, radius = random_arrays(300, seed=5)
    order = np.argsort(mass <= 0, kind="stable")
    pos, mass, radius = pos[order], mass[order], radius[order]
    ml = int(np.count_nonzero(mass > 0))
    g = np.random.default_rng(1).normal(size=(300, 2)).astype(np.float32)
    p = T(pos, grad=True)
    acc = tforces.acc_from_particles(p, T(radius), T(mass), ml)
    acc.backward(T(g))
    _, vjp = jax.vjp(lambda q: jforces.acc_from_particles(
        q, J(radius), J(mass), ml), J(pos))
    assert rel_err(p.grad.numpy(), vjp(J(g))[0]) < TOL_VJP
