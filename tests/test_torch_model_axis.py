"""The model axis for dense-model training on the CPU: SPMD ranks over gloo
(``tests/torch_model_axis_ranks.py``, one process a mesh position, one
torch thread each) on (1, 2), (2, 1) and (2, 2) meshes, held to the JAX
package and to the port's single-device ``Trainer``.

  * Layouts: every rank's shard of the params (as drawn, and after one
    step), of AdamW's mu and nu and of the batch is, bitwise, the slice
    JAX's ``NamedSharding.devices_indices_map`` gives that mesh
    position, for the same rules (one subprocess of the JAX package on
    four forced host devices); the fallback report and the mesh
    signature are JAX's.
  * Values: the step-0 loss within rtol 1e-5 of JAX's single-device
    ``loss_fn`` on the same params and batch; five steps' losses within
    rtol 1e-4 of the port's single-device ``Trainer``; the gathered
    params after one step within ``_params_close``'s rtol = atol = 2e-4
    (where |g| >= 1e-5; everywhere within lr); the train plan on the
    mesh against the plan on one device.
  * Flash's rule with query heads sharded and K/V heads replicated (4
    over 1, 6 over 3) or sharded (4 over 2), forward and gradients,
    against the plain attention on the full tensors at 1e-5.
  * ``compress_decompress`` on DTensor gradients, bitwise the single
    device's; a (1, 2) checkpoint from the async writer restored on
    (1, 1) and (2, 1) bitwise; an injected failure's replay bitwise.
  * What stays refused: the Trainer and prefill and decode plans of a
    family outside the dense and MoE ones (those run:
    ``test_torch_decode_axis.py``, ``test_torch_moe_axis.py``).
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_smoke_arch as j_smoke
from repro.models import build_model as j_build_model
from repro_torch import checkpoint as ckpt
from repro_torch.config import OptimizerConfig, get_smoke_arch
from repro_torch.data.loader import device_batch
from repro_torch.device import FAMILY_SLICE
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import steps
from repro_torch.models import build_model
from repro_torch.models.common import tree_map
from repro_torch.optimizer import adamw, compression
from repro_torch.runtime.train_loop import Trainer
from torch_jax_state import no_jax_constrainer  # noqa: F401
import torch_model_axis_ranks as R
from torch_threads import one_torch_thread  # noqa: F401

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MESHES = ((1, 2), (2, 1), (2, 2))
# the archs each mesh's ranks train (all four dense archs on (1, 2))
ARCHS = {(1, 2): R.DENSE, (2, 1): R.DENSE[:2], (2, 2): R.DENSE[:2]}
JOBS = {(1, 2): "trainer,plan,compress,flash,checkpoint,refusals",
        (2, 1): "trainer", (2, 2): "trainer,flash,compress"}
B1 = OptimizerConfig().b1
ADAM_COND = 1e-5        # tests/test_torch_launch_train.py's


def _params_close(got, want, grads, lr):
    """Every param within lr of ``want``; within rtol = atol = 2e-4
    where |grad| >= ADAM_COND (Adam's first step amplifies rounding of
    tinier gradients: tests/test_torch_launch_train.py)."""
    assert np.abs(got - want).max() <= lr * (1 + 1e-3)
    cond = np.abs(grads) >= ADAM_COND
    np.testing.assert_allclose(got[cond], want[cond], rtol=2e-4, atol=2e-4)


_LAYOUT_SCRIPT = r"""
import json
from types import SimpleNamespace
import jax, jax.numpy as jnp, numpy as np
from repro.checkpoint.checkpoint import _flatten_with_paths
from repro.config import InputShape, get_smoke_arch
from repro.launch.steps import rules_for, shardings_for_tree
from repro.models import build_model, input_axes
from repro.runtime.train_loop import Trainer
SHAPE = InputShape("tiny", 16, 4, "train")
out = {}
for (data, model), archs in json.loads(%r):
    mesh = jax.make_mesh((data, model), ("data", "model"),
                         devices=jax.devices()[:data * model])
    coord = {d.id: list(map(int, i)) for i, d in np.ndenumerate(mesh.devices)}
    for arch in archs:
        cfg = get_smoke_arch(arch)
        m = build_model(cfg)
        rs = rules_for(cfg, SHAPE, mesh)
        sds = jax.eval_shape(m.init, jax.random.key(0))
        psh = shardings_for_tree(rs, m.param_axes(), sds)
        tok = jax.ShapeDtypeStruct((SHAPE.global_batch, SHAPE.seq_len),
                                   jnp.int32)
        bsds = {"tokens": tok, "labels": tok}
        bsh = shardings_for_tree(rs, input_axes(cfg, SHAPE), bsds)
        leaves = {}
        for tree, shapes in ((psh, sds), (bsh, bsds)):
            for (path, sh), (_, sd) in zip(_flatten_with_paths(tree),
                                           _flatten_with_paths(shapes)):
                leaves[path] = {
                    str(coord[d.id]): [[s.start or 0, n if s.stop is None
                                        else s.stop]
                                       for s, n in zip(idx, sd.shape)]
                    for d, idx in sh.devices_indices_map(sd.shape).items()}
        out[f"{data}x{model}/{arch}"] = {
            "leaves": leaves, "fallbacks": rs.fallback_report(),
            "signature": Trainer.mesh_signature(SimpleNamespace(mesh=mesh))}
print("LAYOUT " + json.dumps(out))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh's ranks (all started at once; the (2, 1) ranks restore
    the (1, 2) ranks' checkpoint) and the JAX layouts beside them:
    {"ranks": {(data, model): [each rank's results]}, "jax": {...}}."""
    base = tmp_path_factory.mktemp("model_axis")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = []
    for data, model in MESHES:
        out = base / f"{data}x{model}"
        out.mkdir()
        port, world = _free_port(), data * model
        extra = (["--restore", str(base / "1x2" / "work" / "saved")]
                 if (data, model) == (2, 1) else [])
        for r in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, str(HERE / "torch_model_axis_ranks.py"),
                 "--rank", str(r), "--world", str(world), "--port",
                 str(port), "--data", str(data), "--device", "cpu",
                 "--out", str(out), "--jobs", JOBS[data, model],
                 "--archs", ",".join(ARCHS[data, model])] + extra,
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    single = subprocess.Popen(
        [sys.executable, str(HERE / "torch_model_axis_ranks.py"),
         "--single", "--out", str(base)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    probe = subprocess.Popen(
        [sys.executable, str(ROOT / "tools" / "gloo_probe.py"), "--device",
         "cpu", "--backend", "repro_gloo", "--work", str(base / "probe")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=ROOT)
    cli = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-port", str(_free_port()), "-m",
         "repro_torch.launch.train", "--smoke", "--device", "cpu",
         "--steps", "3", "--ckpt-every", "2", "--mesh", "1,2",
         "--ckpt-dir", str(base / "cli")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    jenv = dict(env, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        env.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=4"))
    spec = json.dumps([[list(m), list(ARCHS[m])] for m in MESHES])
    jax_proc = subprocess.run([sys.executable, "-c", _LAYOUT_SCRIPT % spec],
                              capture_output=True, text=True, env=jenv,
                              timeout=300)
    logs = [p.communicate(timeout=300)[0] for p in procs]
    codes = [p.returncode for p in procs]
    assert codes == [0] * len(procs), "\n".join(
        log[-3000:] for log, c in zip(logs, codes) if c)
    assert jax_proc.returncode == 0, jax_proc.stderr
    line = [x for x in jax_proc.stdout.splitlines()
            if x.startswith("LAYOUT ")][-1]
    ranks = {}
    for data, model in MESHES:
        out = base / f"{data}x{model}"
        ranks[data, model] = [torch.load(out / f"rank{r}.pt",
                                         weights_only=False)
                              for r in range(data * model)]
    cli_out, cli_err = cli.communicate(timeout=300)
    assert cli.returncode == 0, cli_err[-3000:]
    single_log = single.communicate(timeout=300)[0]
    assert single.returncode == 0, single_log[-3000:]
    probe_out, probe_err = probe.communicate(timeout=300)
    assert probe.returncode == 0, probe_err[-3000:]
    return {"ranks": ranks, "jax": json.loads(line[len("LAYOUT "):]),
            "base": base, "cli": cli_out, "probe": json.loads(probe_out),
            "single": torch.load(base / "single.pt", weights_only=False)}


def _single(runs, arch):
    """The port's single-device Trainer on the CPU
    (``torch_model_axis_ranks.single_job``, run beside the ranks):
    (initial params, the step-0 batch, params / mu after one step, step
    0's loss, ``STEPS`` steps' losses), all numpy."""
    r = runs["single"][arch]
    return (r["init"], r["batch"], r["params1"], r["mu1"], r["loss0"],
            r["losses"])


def _slice(arr, box):
    return arr[tuple(slice(a, b) for a, b in box)]


def _cases():
    return [(m, a) for m in MESHES for a in ARCHS[m]]


@pytest.mark.parametrize("mesh,arch", _cases())
def test_shards_are_jax_devices_indices_map(runs, mesh, arch):
    """Each rank's shard of the drawn params (the single device's own
    bits), of the params, mu and nu after a step (slices of their
    gathered values), and of the placed batch, is the slice JAX's
    ``devices_indices_map`` gives that mesh position."""
    jax_leaves = runs["jax"][f"{mesh[0]}x{mesh[1]}/{arch}"]["leaves"]
    init, batch = _single(runs, arch)[:2]
    ranks = runs["ranks"][mesh]
    gathered = ranks[0][arch]
    for res in ranks:
        where = str(res["coordinate"])
        mine = res[arch]
        assert set(mine["init"]) == set(init)
        for path, want in init.items():
            box = jax_leaves[path][where]
            np.testing.assert_array_equal(mine["init"][path],
                                          _slice(want, box))
            for name in ("params1", "mu1", "nu1"):
                np.testing.assert_array_equal(
                    mine[name + "_local"][path],
                    _slice(gathered[name][path], box))
        for key, arr in batch.items():
            np.testing.assert_array_equal(
                mine["batch"][key], _slice(arr, jax_leaves[key][where]))


@pytest.mark.parametrize("mesh,arch", _cases())
def test_fallbacks_and_signature_are_jax(runs, mesh, arch):
    want = runs["jax"][f"{mesh[0]}x{mesh[1]}/{arch}"]
    got = runs["ranks"][mesh][0][arch]
    assert got["fallbacks"] == want["fallbacks"]
    assert got["signature"] == want["signature"] == \
        f"data={mesh[0]}xmodel={mesh[1]}"


@pytest.mark.parametrize("mesh,arch", [c for c in _cases()
                                       if c[0] != (2, 1)])
def test_trainer_matches_jax_and_one_device(runs, mesh, arch):
    """Step 0's loss against JAX's single-device ``loss_fn`` (rtol 1e-5);
    five steps against the port's single-device Trainer (rtol 1e-4); the
    params after one step (``_params_close``)."""
    init, batch, params1, mu1, loss0, losses = _single(runs, arch)
    got = runs["ranks"][mesh][0][arch]
    model = j_build_model(j_smoke(arch))
    jparams = jax.tree.map(jnp.asarray, _nest(init))
    want = float(model.loss_fn(jparams, {k: jnp.asarray(v)
                                         for k, v in batch.items()}))
    np.testing.assert_allclose(got["loss0"], want, rtol=1e-5)
    np.testing.assert_allclose(got["loss0"], loss0, rtol=1e-5)
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-4)
    for path, want_p in params1.items():
        _params_close(got["params1"][path], want_p, mu1[path] / (1 - B1),
                      R.OPT["lr"])


def _nest(flat):
    """{"a/b/c": x} -> {"a": {"b": {"c": x}}}."""
    out = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def test_train_plan_on_the_mesh_matches_one_device(runs):
    """make_train_plan's step on (1, 2) from plain params (it places
    them) at microbatches 1 and 2, against the plan on a 1 x 1 mesh."""
    cfg = get_smoke_arch("smollm-360m")
    opt = OptimizerConfig(**R.OPT)
    res = runs["ranks"][1, 2][0]
    for k in (1, 2):
        plan = steps.make_train_plan(cfg, R.SHAPE,
                                     t_mesh.make_test_mesh(1, 1, "cpu"),
                                     opt_cfg=opt, microbatches=k)
        params = build_model(cfg).init(torch.Generator().manual_seed(0))
        (new, state), m = plan.step_fn((params, adamw.init(opt, params)),
                                       R._batch(cfg))
        np.testing.assert_allclose(res[f"plan{k}"]["loss"], float(m["loss"]),
                                   rtol=1e-5)
        mu = dict(R.leaves(state.mu))
        for path, t in R.leaves(new):
            _params_close(res[f"plan{k}"]["params"][path], R.full(t),
                          R.full(mu[path]) / (1 - B1), R.OPT["lr"])


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
@pytest.mark.parametrize("heads", R.FLASH_CASES)
def test_flash_rule_gives_the_plain_attention(runs, mesh, heads):
    """Query heads over the model axis, K/V heads replicated where they do
    not split (4 over 1, 6 over 3: each rank then takes its own groups'
    KV heads) or sharded (4 over 2): the output (with and without a
    gradient) and dq, dk, dv against the plain attention on the full
    tensors."""
    res = runs["ranks"][mesh][0]["flash"][heads]
    q, k, v, dout = (torch.as_tensor(a) for a in res["inputs"])
    g = heads[0] // heads[1]
    qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
    from repro_torch.kernels.flash_attention import ref
    s = q.shape[1]
    want = ref.attention_einsum(
        qr, ref.expand_kv(kr, g), ref.expand_kv(vr, g),
        ref.attention_mask(s, s, causal=True), q.shape[-1] ** -0.5)
    grads = torch.autograd.grad(want, (qr, kr, vr), dout)
    np.testing.assert_allclose(res["out"], want.detach().numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(res["no_grad"], want.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    for got, w in zip(res["grads"], grads):
        np.testing.assert_allclose(got, w.numpy(), rtol=1e-5, atol=1e-5)
    split = heads[1] % mesh[1] == 0
    assert ("Shard(dim=2)" in res["kv_placements"]) == split


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
def test_compression_on_dtensors_is_the_single_devices(runs, mesh):
    """Two error-feedback rounds on gradients placed as llama3-8b SMOKE's
    params: the scale is the global max, so ĝ and the residual are
    bitwise the single-device round trip's; residuals are placed as
    their params."""
    rounds = runs["ranks"][mesh][0]["compress"]
    assert all(r["residual_placed"] for r in runs["ranks"][mesh])
    residual = None
    for ghat, res, raw in rounds:
        grads = tree_map(torch.as_tensor, _nest(raw))
        if residual is None:
            residual = compression.init_residual(grads)
        want_g, residual = compression.compress_decompress(grads, residual)
        flat_g, flat_r = dict(R.leaves(want_g)), dict(R.leaves(residual))
        for path in raw:
            np.testing.assert_array_equal(ghat[path], flat_g[path].numpy())
            np.testing.assert_array_equal(res[path], flat_r[path].numpy())


def test_checkpoint_restores_elastically(runs):
    """A (1, 2) checkpoint written from the async thread (rank 0) holds the
    gathered state and JAX's mesh signature; it restores bitwise on a
    one-device (1, 1) mesh and on the (2, 1) ranks."""
    res = runs["ranks"][1, 2][0]
    saved = Path(res["saved_dir"])
    assert res["async_write"] and ckpt.list_steps(str(saved)) == [2]
    manifest = json.loads((saved / "step_000000002" /
                           "manifest.json").read_text())
    assert manifest["mesh_signature"] == runs["jax"][
        "1x2/smollm-360m"]["signature"] == "data=1xmodel=2"
    with np.load(saved / "step_000000002" / "arrays.npz") as data:
        stored = {k: data[k] for k in data.files}
    assert set(stored) == set(res["saved"])
    for k, v in res["saved"].items():
        np.testing.assert_array_equal(stored[k], v)
    cfg = get_smoke_arch("smollm-360m")
    one = t_mesh.make_test_mesh(1, 1, "cpu")
    with Trainer(cfg, R.train_config(saved), one, device="cpu") as tr:
        state, step = tr.restore_latest()
        assert step == 2
        for k, t in R.leaves(tr._checkpoint_tree(state)):
            np.testing.assert_array_equal(R.full(t), stored[k])
    back = runs["ranks"][2, 1]
    assert back[0]["restored_step"] == 2
    for k, v in back[0]["restored"].items():
        np.testing.assert_array_equal(v, stored[k])


def test_injected_failure_replays_bitwise(runs):
    """A WorkerFailure at step 3 on (1, 2) restores step 2's checkpoint
    (every 2 steps) and replays step 2: the losses are the clean run's,
    bitwise, with step 2's twice."""
    res = runs["ranks"][1, 2][0]
    clean, rep = res["clean"], res["replay"]
    assert rep["restarts"] == 1
    assert rep["losses"] == clean[:3] + clean[2:]


def test_what_stays_refused_names_its_slice(runs):
    """On a (1, 2) mesh of SPMD ranks: the prefill and decode plans'
    steps and the Trainer of a family outside the dense, MoE and RWKV6
    ones (zamba2-2.7b, internvl2-1b) raise NotImplementedError naming the
    slices that will take them; llama3-8b's, qwen3-moe-30b-a3b's and
    rwkv6-7b's prefill and decode plans and rwkv6-7b's Trainer run
    (``tests/test_torch_decode_axis.py``, ``tests/test_torch_moe_axis.py``
    and ``tests/test_torch_rwkv_axis.py`` hold their values)."""
    msgs = runs["ranks"][1, 2][0]["refusals"]
    for arch in ("llama3-8b", "qwen3-moe-30b-a3b", "rwkv6-7b"):
        for kind in ("prefill", "decode"):
            assert msgs[f"{arch}/{kind}"] == "ran"
    assert msgs["rwkv6-7b"] == "ran"
    assert "Mamba2/zamba2" in FAMILY_SLICE and "RWKV6" not in FAMILY_SLICE
    for arch in ("zamba2-2.7b", "internvl2-1b"):
        for what in (arch, f"{arch}/prefill", f"{arch}/decode"):
            assert "families under a model axis" in msgs[what], what
            assert FAMILY_SLICE in msgs[what], what


def test_train_cli_under_torchrun(runs):
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.train --mesh
    1,2``: the ranks train over the world's (1, 2) mesh, rank 0 prints
    once, and the checkpoint carries the mesh's signature; its losses are
    those of the Trainer the CLI builds, on one device."""
    assert runs["cli"].count("final loss") == 1
    base = runs["base"] / "cli"
    assert ckpt.list_steps(str(base)) == [2]
    manifest = json.loads((base / "step_000000002" /
                           "manifest.json").read_text())
    assert manifest["mesh_signature"] == "data=1xmodel=2"
    logged = [json.loads(x) for x in
              (base / "metrics.jsonl").read_text().splitlines()]
    np.testing.assert_allclose([r["loss"] for r in logged],
                               runs["single"]["cli_losses"], rtol=1e-4)


def test_repro_gloo_backend_carries_every_collective(runs):
    """The port's own backend (``launch.dist.HostStagedGloo``: gloo over
    host copies, what ranks sharing a card run) on two CPU ranks
    (``tools/gloo_probe.py``): every collective and every DTensor
    redistribution the probe makes gives the right answer."""
    got = runs["probe"]
    assert got["ranks_agree"]
    probes = {**got["rank0"]["collectives"],
              **got["rank0"]["redistributions"]}
    assert len(probes) == 13 and set(probes.values()) == {"ok"}, probes
