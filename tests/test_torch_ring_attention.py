"""Context-parallel attention of the port (``paddle_tpu_torch/ops/
ring_attention.py`` over ``distributed/sep_transport.py``) against the
JAX package's ``ring_attention_values`` and ``ulysses_attention_values``
under ``shard_map`` on the session's virtual CPU mesh, at sep 2 and sep 4.

The port's four gloo ranks are launched once for the file: a sep-4 mesh
and a dp-2 x sep-2 mesh (each sep pair runs the same case), every case
on both. Each rank saves its shard of the output and of the gradients of
``sum(out * cot)`` with respect to q, k and v.

- The ring, causal: the zigzag schedule on the kernel route (local
  halves multiples of 128, so the plain K2/K3 run on the CPU) and on the
  dense route (d = 16); non-causal: the plain rotation on both routes;
  the degenerate causal route (an odd local shard).
- Ulysses, causal and not, on both routes; heads that do not divide by
  the sep degree raise ``ValueError``.
- The caller's own zigzag layout (``zigzag=True``): shards gathered by
  ``zigzag_indices``, against the reference's ``zigzag=True``.
- The zigzag shuffles: natural shards into the zigzag layout (equal to
  the reference's ``_shuffle_to_zigzag``) and back (the identity), with
  the gradients through both.

Inputs are numpy draws from a seed, fp32. Tolerance: every output and
gradient within 1e-5 of its largest entry, against the reference under
``shard_map`` and against one device's attention. The JAX side takes its
dense route (``PDTPU_PALLAS_INTERPRET=0`` while it runs).
"""
import json
import os

import numpy as np
import pytest

from _torch_hybrid_helpers import assert_check, rel_err, run_ranks, save_npz

TOL = 1e-5
# name: (mode, causal, the global (b, s, h, d); the odd case's s is per
# rank)
CASES = {
    "zigzag_kernel": ("ring", True, (1, 1024, 2, 64)),
    "zigzag_dense": ("ring", True, (2, 64, 4, 16)),
    "ring_kernel": ("ring", False, (1, 1024, 2, 64)),
    "ring_dense": ("ring", False, (2, 64, 4, 16)),
    "ring_odd_causal": ("ring", True, (2, 3, 4, 16)),
    # the caller lays the shards out in zigzag order (zigzag=True)
    "zigzag_pre_permuted": ("ring", True, (1, 1024, 2, 64)),
    "ulysses_kernel_causal": ("ulysses", True, (1, 512, 4, 64)),
    "ulysses_kernel": ("ulysses", False, (1, 512, 4, 64)),
    "ulysses_dense_causal": ("ulysses", True, (2, 64, 4, 16)),
}
SEPS = (2, 4)


def _shape(case, sep):
    b, s, h, d = CASES[case][2]
    if case == "ring_odd_causal":
        s = s * sep                  # a local shard of 3
    return b, s, h, d


_WORKER = """
from paddle_tpu_torch.distributed.fleet.utils.sequence_parallel_utils \
    import zigzag_indices
from paddle_tpu_torch.distributed.sharding_api import build_mesh
from paddle_tpu_torch.ops import ring_attention as ra

D = np.load(f"{DATA}/inputs.npz")
CASES = json.loads(str(D["cases"]))
out = {}
meshes = {4: build_mesh(sep=4), 2: build_mesh(dp=2, sep=2)}
for sep, mesh in meshes.items():
    g = mesh.group("sep")
    me = g.rank
    for case, (mode, causal) in CASES.items():
        q, k, v, cot = (torch.from_numpy(D[f"{case}/{sep}/{t}"])
                        for t in ("q", "k", "v", "cot"))
        pre = case == "zigzag_pre_permuted"
        if pre:
            idx = torch.from_numpy(zigzag_indices(q.shape[1], sep))
            q, k, v, cot = (t[:, idx] for t in (q, k, v, cot))
        sl = q.shape[1] // sep
        loc = [t[:, me * sl:(me + 1) * sl].clone().requires_grad_(True)
               for t in (q, k, v)]
        if mode == "ring":
            o = ra.ring_attention_values(*loc, causal=causal, group=g,
                                         zigzag=pre)
        else:
            o = ra.ulysses_attention_values(*loc, causal=causal, group=g)
        (o * cot[:, me * sl:(me + 1) * sl]).sum().backward()
        for name, t in zip(("o", "dq", "dk", "dv"),
                           (o,) + tuple(x.grad for x in loc)):
            out[f"{case}/{sep}/{name}/{me}"] = t.detach().numpy()
    ok(f"sep{sep}")
    # the shuffles, and their gradients, on one tensor
    x = torch.from_numpy(D[f"shuffle/{sep}/x"])
    cot = torch.from_numpy(D[f"shuffle/{sep}/cot"])
    sl = x.shape[1] // sep
    xl = x[:, me * sl:(me + 1) * sl].clone().requires_grad_(True)
    z = ra._shuffle_to_zigzag([xl], g)[0]
    back = ra._shuffle_from_zigzag([z * 2.0], g)[0]
    (back * cot[:, me * sl:(me + 1) * sl]).sum().backward()
    out[f"shuffle/{sep}/z/{me}"] = z.detach().numpy()
    out[f"shuffle/{sep}/back/{me}"] = back.detach().numpy()
    out[f"shuffle/{sep}/dx/{me}"] = xl.grad.numpy()
    ok(f"shuffle{sep}")
np.savez(f"{DATA}/port_{RANK}.npz", **out)
ok("saved")
"""


def _jax_case(mode, causal, sep, q, k, v, cot, zigzag=False):
    """The reference under shard_map on ``sep`` virtual devices: (o, dq,
    dk, dv) of sum(o * cot), and one device's attention's. With
    ``zigzag`` the shards are laid out in zigzag order first, and every
    result is returned in that order."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from paddle_tpu.distributed.sharding_api import compat_shard_map
    from paddle_tpu.nn.functional.attention import _sdpa_impl
    from paddle_tpu.ops.ring_attention import (ring_attention_values,
                                               ulysses_attention_values)
    fn = ring_attention_values if mode == "ring" else \
        ulysses_attention_values
    mesh = Mesh(np.asarray(jax.devices()[:sep]), ("sep",))
    spec = P(None, "sep", None, None)
    kw = {"zigzag": True} if zigzag else {}
    mapped = compat_shard_map()(
        lambda a, b, c: fn(a, b, c, axis_name="sep", causal=causal, **kw),
        mesh=mesh, in_specs=(spec,) * 3, out_specs=spec)
    d = q.shape[-1]
    single = lambda a, b, c: _sdpa_impl(a, b, c, None,  # noqa: E731
                                        1.0 / np.sqrt(d), causal)
    idx = np.arange(q.shape[1])
    if zigzag:
        from paddle_tpu.distributed.fleet.utils.sequence_parallel_utils \
            import zigzag_indices
        idx = zigzag_indices(q.shape[1], sep)
    zq, zk, zv, zcot = (a[:, idx] for a in (q, k, v, cot))
    res = {}
    for tag, f, cot_ in (("ref", mapped, zcot), ("one", single, cot)):
        def loss(a, b, c):
            o = f(a, b, c)
            return jnp.sum(o * cot_), o
        args = (zq, zk, zv) if tag == "ref" else (q, k, v)
        (_, o), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(*args)
        out = [np.asarray(o)] + [np.asarray(g) for g in grads]
        res[tag] = out if tag == "ref" else [x[:, idx] for x in out]
    return res


def _jax_shuffle(sep, x):
    """The reference's ``_shuffle_to_zigzag`` of natural shards."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from paddle_tpu.distributed.sharding_api import compat_shard_map
    from paddle_tpu.ops import ring_attention as jra
    mesh = Mesh(np.asarray(jax.devices()[:sep]), ("sep",))
    spec = P(None, "sep", None, None)
    f = compat_shard_map()(
        lambda a: jra._shuffle_to_zigzag(a, "sep", sep,
                                         jax.lax.axis_index("sep")),
        mesh=mesh, in_specs=(spec,), out_specs=spec)
    return np.asarray(jax.jit(f)(x))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("ring_attention")
    rng = np.random.default_rng(0)
    data, ref = {}, {}
    old = os.environ.get("PDTPU_PALLAS_INTERPRET")
    os.environ["PDTPU_PALLAS_INTERPRET"] = "0"   # the JAX dense routes
    try:
        for sep in SEPS:
            for case, (mode, causal, _) in CASES.items():
                shape = _shape(case, sep)
                q, k, v, cot = (rng.standard_normal(shape).astype(np.float32)
                                for _ in range(4))
                for t, a in zip(("q", "k", "v", "cot"), (q, k, v, cot)):
                    data[f"{case}/{sep}/{t}"] = a
                ref[(case, sep)] = _jax_case(
                    mode, causal, sep, q, k, v, cot,
                    zigzag=case == "zigzag_pre_permuted")
            x = rng.standard_normal((2, 8 * sep, 3, 4)).astype(np.float32)
            data[f"shuffle/{sep}/x"] = x
            data[f"shuffle/{sep}/cot"] = rng.standard_normal(
                x.shape).astype(np.float32)
            ref[("shuffle", sep)] = _jax_shuffle(sep, x)
    finally:
        if old is None:
            os.environ.pop("PDTPU_PALLAS_INTERPRET", None)
        else:
            os.environ["PDTPU_PALLAS_INTERPRET"] = old
    save_npz(d / "inputs.npz", cases=np.array(json.dumps(
        {c: [m, ca] for c, (m, ca, _) in CASES.items()})), **data)
    logs = run_ranks(d, _WORKER, {"dp_degree": 4}, nproc=4)
    port = {}
    for r in range(4):
        port.update(np.load(d / f"port_{r}.npz"))
    return {"logs": logs, "ref": ref, "port": port, "data": data}


def _gathered(port, key, sep):
    return np.concatenate([port[f"{key}/{r}"] for r in range(sep)], axis=1)


@pytest.mark.parametrize("sep", SEPS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_the_reference_under_shard_map(run, case, sep):
    assert_check(run["logs"], f"sep{sep}", nproc=4)
    if (case, sep) not in run["ref"]:
        pytest.fail(f"no reference for {case} at sep {sep}")
    ref = run["ref"][(case, sep)]
    for i, name in enumerate(("o", "dq", "dk", "dv")):
        got = _gathered(run["port"], f"{case}/{sep}/{name}", sep)
        for tag in ("ref", "one"):
            want = ref[tag][i]
            assert got.shape == want.shape, (case, name)
            err = rel_err(got, want)
            assert err <= TOL, (case, sep, name, tag, err)


@pytest.mark.parametrize("sep", SEPS)
def test_zigzag_shuffles_match_the_reference(run, sep):
    assert_check(run["logs"], f"shuffle{sep}", nproc=4)
    port, x = run["port"], run["data"][f"shuffle/{sep}/x"]
    cot = run["data"][f"shuffle/{sep}/cot"]
    z = _gathered(port, f"shuffle/{sep}/z", sep)
    np.testing.assert_array_equal(z, run["ref"][("shuffle", sep)])
    # the layout is the reference's zigzag_indices gather
    from paddle_tpu.distributed.fleet.utils.sequence_parallel_utils import \
        zigzag_indices
    np.testing.assert_array_equal(z, x[:, zigzag_indices(x.shape[1], sep)])
    np.testing.assert_array_equal(_gathered(port, f"shuffle/{sep}/back",
                                            sep), 2.0 * x)
    np.testing.assert_array_equal(_gathered(port, f"shuffle/{sep}/dx", sep),
                                  2.0 * cot)


def test_ulysses_heads_must_divide_by_sep():
    import torch

    from paddle_tpu_torch.distributed.collective import Group
    from paddle_tpu_torch.ops import ring_attention as ra
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="divide by the sep degree 4"):
        ra.ulysses_attention_values(q, q, q, group=Group([0, 1, 2, 3]))


def test_routes_follow_the_gates():
    """The zigzag gate admits the kernel cases' local shards and refuses
    the dense ones; the reference's gate agrees on the same shapes once
    its TPU and 512-token checks are set aside."""
    import torch

    from paddle_tpu_torch.ops import cuda_kernels as ck
    from paddle_tpu_torch.ops import ring_attention as ra
    for sep in SEPS:
        b, s, h, d = _shape("zigzag_kernel", sep)
        q = torch.zeros(b, s // sep, h, d)
        assert ra.zigzag_flash_available(q, q, q)
        b, s, h, d = _shape("zigzag_dense", sep)
        q = torch.zeros(b, s // sep, h, d)
        assert not ra.zigzag_flash_available(q, q, q)
        b, s, h, d = _shape("ring_kernel", sep)
        assert ck.flash_attention_available(torch.zeros(b, s // sep, h, d))
    # odd local halves: the zigzag gate refuses
    q = torch.zeros(1, 384, 2, 64)
    assert not ra.zigzag_flash_available(q, q, q)


@pytest.mark.parametrize("backend,device,staged", [
    ("gloo", "cuda", True), ("gloo", "cpu", False), ("nccl", "cuda", False)])
def test_host_staging_is_chosen_by_backend_and_device(monkeypatch, backend,
                                                      device, staged):
    """Point-to-point buffers go through the host exactly for gloo with
    CUDA tensors (gloo writes a CUDA pointer as a host one and the
    socket refuses it), decided up front."""
    import torch

    from paddle_tpu_torch.distributed import collective, sep_transport
    monkeypatch.setattr(collective, "get_backend", lambda group=None: backend)
    assert sep_transport._stages(collective.Group([0, 1]),
                                 torch.device(device)) is staged
