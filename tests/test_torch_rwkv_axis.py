"""The RWKV6 family on a model axis, on the CPU: SPMD ranks over gloo
(``tests/torch_rwkv_axis_ranks.py``, one process a mesh position, one
torch thread each) on (1, 2), (2, 1) and (2, 2) meshes, held to the JAX
package and to the port's one-device paths, for rwkv6-7b SMOKE (4 heads
of 16) in float32. The recurrence runs on each rank's heads
(``models.rwkv.recurrence``, ``kernels.wkv6.ops.RankHeads``); params are
JAX-drawn and carried with ``models.params_from_jax`` except the
Trainer's, which draws its own on every rank and on one device alike.

  * Values: the loss (rtol 1e-5) and every leaf's gradient of
    ``loss_fn`` on the mesh, in "direct" and "factored" mode, against
    ``jax.value_and_grad`` of JAX's ``loss_fn`` in the same mode, within
    1e-4 of max |JAX| a leaf (the one-device bar of
    ``tests/test_torch_train_loss.py``); the ``Trainer`` ("direct"
    mode): step 0's loss against JAX's and the one-device Trainer's
    (rtol 1e-5), its three losses (rtol 1e-4), its params and AdamW mu
    after one step against the one-device Trainer's; the train plan at
    two microbatches against the one-device plan; the prefill plan's last
    logits and state and each decode step's logits and the state after
    them against JAX's single-device ``prefill`` and ``decode_step`` in
    the factored mode (1e-5 of max |JAX|); ``generate`` with a factored
    model and with the default kernel-mode one equal to one device's, a
    token whose one-device top-2 margin is under TIE accepted either way.
  * The recurrence alone, in each mode, on placed (b, s, H, K) inputs:
    y against JAX's sequential ``ref_wkv6`` (1e-5 of max |JAX|), y and
    the final state against the port's one-device call, the kernel
    mode's rows bitwise the one-device call's; no collective inside it
    (``CommDebugMode`` and ``launch.dist.COMM``); y placed with H over
    "model", the state likewise.
  * FSDP: on (2, 2) the rules ``rules_for`` gives the full rwkv6-7b
    (``embed`` and ``fsdp_embed`` over "data"): the gradients, the
    recurrence, the train plan and serving as above.
  * Layouts: every rank's shard of the time-mix's and channel-mix's
    weights, and of their AdamW mu and nu after a step (the Trainer's,
    and the FSDP plan's), is bitwise the slice JAX's
    ``devices_indices_map`` gives that mesh position for the same rules
    (one subprocess of the JAX package on forced host devices); the
    prefill plan's and every decode step's state is placed as the plans
    say, each rank's shard the slice JAX's decode plan gives it (the WKV
    state's heads replicated over "model"); the fallback reports are
    JAX's.
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
from repro.kernels.wkv6 import ref as j_wref
from repro.models import build_model as j_build_model
from repro_torch.config import OptimizerConfig, get_smoke_arch
from repro_torch.data.loader import device_batch
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import steps
from repro_torch.models import build_model, params_from_jax, rwkv
from repro_torch.optimizer import adamw
from repro_torch.runtime.serve_loop import generate
from repro_torch.runtime.train_loop import Trainer
from torch_jax_state import no_jax_constrainer  # noqa: F401
import torch_rwkv_axis_ranks as R

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
REL = 1e-5
GRAD_REL = 1e-4
TIE = 1e-4
B1 = OptimizerConfig().b1
ADAM_COND = 1e-5        # tests/test_torch_launch_train.py's
ALL_JOBS = ["grad", "layer", "trainer", "plan", "serve"]

CASES = {
    (1, 2): [dict(rules="default", jobs=ALL_JOBS)],
    (2, 1): [dict(rules="default", jobs=ALL_JOBS)],
    (2, 2): [dict(rules="default", jobs=ALL_JOBS),
             dict(rules="fsdp", jobs=["grad", "layer", "plan", "serve"])],
}
MESHES = tuple(CASES)

_LAYOUT_SCRIPT = r"""
import json
import jax, numpy as np
from repro.config import InputShape, get_smoke_arch
from repro.launch.steps import make_plan, rules_for, shardings_for_tree
from repro.models import build_model
spec, rules, arch, (seq, batch), (sb, sp) = json.loads(%r)
SHAPE = InputShape("tiny", seq, batch, "train")
DECODE = InputShape("decode", sp, sb, "decode")
cfg = get_smoke_arch(arch)
m = build_model(cfg)
sds = jax.eval_shape(m.init, jax.random.key(0))
cache_sds, _ = m.cache_spec(sb, sp)
out = {}


def boxes(sh, shape, coord):
    return {str(coord[d.id]): [[s.start or 0, n if s.stop is None
                                else s.stop] for s, n in zip(idx, shape)]
            for d, idx in sh.devices_indices_map(shape).items()}


for (data, model), names in spec:
    mesh = jax.make_mesh((data, model), ("data", "model"),
                         devices=jax.devices()[:data * model])
    coord = {d.id: list(map(int, i)) for i, d in np.ndenumerate(mesh.devices)}
    for name in names:
        rs = rules_for(cfg, SHAPE, mesh, rules[name])
        psh = shardings_for_tree(rs, m.param_axes(), sds)
        leaves = {}
        for block in ("time", "channel"):
            for leaf, sh in psh["blocks"]["p0"][block].items():
                shape = sds["blocks"]["p0"][block][leaf].shape
                leaves["blocks/p0/%%s/%%s" %% (block, leaf)] = boxes(
                    sh, shape, coord)
        plan = make_plan(cfg, DECODE, mesh, rule_overrides=rules[name])
        state = {"p0/" + leaf: boxes(sh, cache_sds["p0"][leaf].shape,
                                             coord)
                 for leaf, sh in plan.out_shardings[1]["p0"].items()}
        out["{}x{}/{}".format(data, model, name)] = {
            "leaves": leaves, "state": state,
            "fallbacks": rs.fallback_report()}
print("LAYOUT " + json.dumps(out))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


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


def _jax_grads(params):
    """JAX's single-device loss and every gradient of ``loss_fn`` in each
    of GRAD_MODES."""
    batch = {k: jnp.asarray(v) for k, v in
             R.batch_tokens(get_smoke_arch(R.ARCH)).items()}
    out = {}
    for mode in R.GRAD_MODES:
        model = j_build_model(j_smoke(R.ARCH), rwkv_mode=mode)
        loss, grads = jax.jit(jax.value_and_grad(model.loss_fn))(params,
                                                                 batch)
        out[mode] = (float(loss), _flat(grads))
    return out


def _layer_refs():
    """JAX's sequential WKV6 on the layer inputs, and the port's
    one-device recurrence in each mode (y, state)."""
    r, k, v, lw, u = R.layer_input(get_smoke_arch(R.ARCH))
    want = np.asarray(j_wref.ref_wkv6(*(jnp.asarray(t)
                                        for t in (r, k, v, lw, u))))
    one = {}
    uneven = {}
    h = R.UNEVEN_HEADS
    with torch.no_grad():
        for mode in rwkv.MODES:
            y, S = rwkv.recurrence(mode, *(torch.as_tensor(t) for t in
                                           (r, k, v, lw, u)),
                                   return_state=True)
            one[mode] = (y.numpy(), S.numpy())
            uneven[mode] = rwkv.recurrence(mode, *(
                torch.as_tensor(t[:, :, :h]) for t in (r, k, v, lw)),
                torch.as_tensor(u[:h])).numpy()
    return {"jax": want, "one": one, "uneven": uneven}


def _jax_timemix(params):
    """JAX's layer-0 time-mix on the layer job's input."""
    from repro.models import rwkv as j_rwkv
    x = np.random.default_rng(8).normal(
        size=R.LAYER_SHAPE + (get_smoke_arch(R.ARCH).d_model,)).astype(
            np.float32)
    p = jax.tree.map(lambda t: t[0], params["blocks"])["p0"]["time"]
    return np.asarray(j_rwkv.timemix_apply(p, jnp.asarray(x),
                                           j_smoke(R.ARCH)))


def _jax_serve(params):
    """JAX's single-device prefill (last logits and state) and decode
    steps teacher-forced on the case's tokens, in the factored mode (the
    plans')."""
    model = j_build_model(j_smoke(R.ARCH), rwkv_mode="factored")
    toks = R.serve_tokens(get_smoke_arch(R.ARCH))
    P = R.SERVE["prompt"]
    logits, cache = jax.jit(model.prefill)(params, jnp.asarray(toks[:, :P]))
    ref = {"last": np.asarray(logits[:, -1]), "state": _flat(cache),
           "steps": []}
    step = jax.jit(model.decode_step)
    for t in range(R.SERVE["steps"]):
        pos = P + t
        logits, cache = step(params, jnp.asarray(toks[:, pos:pos + 1]),
                             jnp.asarray(pos, jnp.int32), cache)
        ref["steps"].append(np.asarray(logits[:, -1]))
    ref["final"] = _flat(cache)
    return ref


def _generate_with_margins(model, params, toks):
    got = generate(model, params, toks, R.GEN_STEPS)
    logits, cache = model.prefill(params, torch.as_tensor(toks))
    margins = []
    for t in range(R.GEN_STEPS):
        top = torch.topk(logits[:, -1], 2).values
        margins.append((top[:, 0] - top[:, 1]).numpy())
        if t + 1 < R.GEN_STEPS:
            logits, cache = model.decode_step(
                params, torch.as_tensor(got[:, t:t + 1]), toks.shape[1] + t,
                cache)
    return got, np.stack(margins, axis=1)


def _one_device(params_np, work: Path):
    """The port's one-device Trainer (its own init), the train plan from
    the carried params at 1 and MICRO microbatches, and ``generate`` with
    each token's top-2 margin in the factored and the kernel mode, on
    the CPU."""
    cfg = get_smoke_arch(R.ARCH)
    out = {}
    with Trainer(cfg, R.train_config(work / "trainer"), device="cpu") as tr:
        s0 = tr.init_state()
        batch = tr.loader.batch(0)
        init = _nest({k: R.full(t) for k, t in R.flatten_with_paths(s0[0])})
        jax_loss0 = float(j_build_model(j_smoke(R.ARCH)).loss_fn(
            jax.tree.map(jnp.asarray, init),
            {k: jnp.asarray(v) for k, v in batch.items()}))
        s1, m = tr._step(s0, device_batch(batch, device="cpu"))
        out["trainer"] = {
            "loss0": float(m["loss"]), "jax_loss0": jax_loss0,
            "params1": {k: R.full(t) for k, t in R.flatten_with_paths(s1[0])},
            "mu1": {k: R.full(t) for k, t in R.flatten_with_paths(s1[1].mu)},
            "losses": tr.run(R.STEPS, resume=False).losses}
    opt = OptimizerConfig(**R.OPT)
    one = t_mesh.make_test_mesh(1, 1, "cpu")
    for micro in (1, R.MICRO):
        plan = steps.make_train_plan(cfg, R.SHAPE, one, opt_cfg=opt,
                                     microbatches=micro)
        params = params_from_jax(params_np, "cpu")
        (new, state), m = plan.step_fn((params, adamw.init(opt, params)),
                                       R.batch_tokens(cfg))
        out[f"plan{micro}"] = {
            "loss": float(m["loss"]),
            "params": {k: R.full(t) for k, t in R.flatten_with_paths(new)},
            "mu": {k: R.full(t) for k, t in R.flatten_with_paths(state.mu)}}
    params = params_from_jax(params_np, "cpu")
    toks = R.serve_tokens(cfg)[:, :R.SERVE["prompt"]]
    out["generate"] = _generate_with_margins(
        build_model(cfg, rwkv_mode="factored"), params, toks)
    out["generate_kernel"] = _generate_with_margins(build_model(cfg),
                                                    params, toks)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh's ranks (all started at once), the JAX layouts beside
    them, and, while they run, the JAX references and the port's
    one-device runs in this process."""
    base = tmp_path_factory.mktemp("rwkv_axis")
    params_np = _np_tree(j_build_model(j_smoke(R.ARCH)).init(
        jax.random.key(0)))
    torch.save(params_np, base / "params.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = []
    for data, model in MESHES:
        out = base / f"{data}x{model}"
        out.mkdir()
        port, world = _free_port(), data * model
        for r in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, str(HERE / "torch_rwkv_axis_ranks.py"),
                 "--rank", str(r), "--world", str(world), "--port",
                 str(port), "--data", str(data), "--device", "cpu",
                 "--params", str(base / "params.pt"), "--cases",
                 json.dumps(CASES[data, model]), "--out", str(out)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    jenv = dict(env, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        env.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=4"))
    names = [[list(m), sorted({c["rules"] for c in CASES[m]})]
             for m in MESHES]
    spec = json.dumps([names, R.RULES, R.ARCH,
                       [R.SHAPE.seq_len, R.SHAPE.global_batch],
                       [R.SERVE["batch"],
                        R.SERVE["prompt"] + R.SERVE["steps"]]])
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _LAYOUT_SCRIPT % spec],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=jenv)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        jparams = jax.tree.map(jnp.asarray, params_np)
        refs = {"grads": _jax_grads(jparams), "layer": _layer_refs(),
                "timemix": _jax_timemix(jparams),
                "serve": _jax_serve(jparams),
                "one": _one_device(params_np, base / "single")}
    finally:
        torch.set_num_threads(threads)
    jax_out, jax_err = jax_proc.communicate(timeout=300)
    logs = [p.communicate(timeout=300)[0] for p in procs]
    codes = [p.returncode for p in procs]
    assert codes == [0] * len(procs), "\n".join(
        log[-3000:] for log, c in zip(logs, codes) if c)
    assert jax_proc.returncode == 0, jax_err
    line = [x for x in jax_out.splitlines() if x.startswith("LAYOUT ")][-1]
    ranks = {(d, m): [torch.load(base / f"{d}x{m}" / f"rank{r}.pt",
                                 weights_only=False)
                      for r in range(d * m)] for d, m in MESHES}
    return {"ranks": ranks, "jax": json.loads(line[len("LAYOUT "):]),
            "refs": refs}


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / (np.abs(want).max() + 1e-9))


def _slice(arr, box):
    return arr[tuple(slice(a, b) for a, b in box)]


def _params_close(got, want, grads, lr):
    """Every param within lr of ``want``; within rtol = atol = 2e-4
    where |grad| >= ADAM_COND (Adam's first step amplifies rounding of
    tinier gradients: tests/test_torch_launch_train.py)."""
    assert np.abs(got - want).max() <= lr * (1 + 1e-3)
    cond = np.abs(grads) >= ADAM_COND
    np.testing.assert_allclose(got[cond], want[cond], rtol=2e-4, atol=2e-4)


def _params(job):
    return [pytest.param(m, c, id=f"{m[0]}x{m[1]}-{R.case_name(c)}")
            for m, cs in CASES.items() for c in cs if job in c["jobs"]]


def _got(runs, mesh, case, job, rank=0):
    return runs["ranks"][mesh][rank][R.case_name(case)][job]


@pytest.mark.parametrize("mode", R.GRAD_MODES)
@pytest.mark.parametrize("mesh,case", _params("grad"))
def test_loss_and_gradients_match_jax(runs, mesh, case, mode):
    """loss_fn's value (rtol 1e-5) and every leaf's gradient on the mesh
    against ``jax.value_and_grad`` of JAX's ``loss_fn`` in the same mode,
    within 1e-4 of max |JAX| a leaf."""
    got = _got(runs, mesh, case, "grad")[mode]
    loss, grads = runs["refs"]["grads"][mode]
    np.testing.assert_allclose(got["loss"], loss, rtol=REL)
    assert set(got["grads"]) == set(grads)
    for path, want in grads.items():
        assert _rel(got["grads"][path], want) <= GRAD_REL, (
            path, _rel(got["grads"][path], want))


@pytest.mark.parametrize("mode", rwkv.MODES)
@pytest.mark.parametrize("mesh,case", _params("layer"))
def test_recurrence_on_rank_heads(runs, mesh, case, mode):
    """The recurrence alone on placed inputs: y within 1e-5 of max |JAX|
    of JAX's sequential ``ref_wkv6`` and of the one-device call, the
    final state within 1e-5 of the one-device one; the rank's rows
    (its batch rows, its heads) bitwise the one-device call's in the
    kernel mode; y and the state placed with H over "model"; nothing
    exchanged inside the call."""
    data, model = mesh
    refs = runs["refs"]["layer"]
    y1, S1 = refs["one"][mode]
    for res in runs["ranks"][mesh]:
        got = res[R.case_name(case)]["layer"][mode]
        assert got["collectives"] == 0 and got["comm_calls"] == 0
        assert got["launches"] == 0           # no kernel on the CPU
        assert _rel(got["y"], refs["jax"]) <= REL
        assert _rel(got["y"], y1) <= REL and _rel(got["state"], S1) <= REL
        rows = "Shard(dim=0)" if data > 1 else "Replicate()"
        heads = "Shard(dim=2)" if model > 1 else "Replicate()"
        assert got["y_placements"] == f"[{rows}, {heads}]"
        assert got["state_placements"] == "[{}, {}]".format(
            rows, heads.replace("2", "1"))
        i, j = res["coordinate"]
        b, H = y1.shape[0] // data, y1.shape[2] // model
        mine = y1[i * b:(i + 1) * b, :, j * H:(j + 1) * H]
        if mode == "kernel":
            np.testing.assert_array_equal(got["y_local"], mine)
        else:
            assert _rel(got["y_local"], mine) <= REL


@pytest.mark.parametrize("mode", rwkv.MODES)
@pytest.mark.parametrize("mesh,case", _params("layer"))
def test_uneven_heads_are_gathered(runs, mesh, case, mode):
    """Three heads sharded unevenly over a "model" axis of 2: the heads
    are gathered (y replicated over "model"), every rank runs them all,
    and y is the one-device call's within 1e-5 of its max (on (2, 1) the
    one-way "model" shard is whole)."""
    want = runs["refs"]["layer"]["uneven"][mode]
    for res in runs["ranks"][mesh]:
        got = res[R.case_name(case)]["layer"][mode]["uneven"]
        assert _rel(got["y"], want) <= REL
        if mesh[1] > 1:
            assert got["y_placements"].endswith("Replicate()]")


@pytest.mark.parametrize("mesh,case", _params("layer"))
def test_timemix_exchanges_only_its_output(runs, mesh, case):
    """Layer 0's whole time-mix on a placed input against JAX's
    ``timemix_apply`` (1e-5 of max |JAX|); under the default rules its
    only collective is one all-reduce of the output's partial sums over
    "model" (none without a model axis): the reshape to heads, the
    recurrence and the per-head group norm gather nothing."""
    want = runs["refs"]["timemix"]
    for res in runs["ranks"][mesh]:
        got = res[R.case_name(case)]["layer"]["timemix"]
        assert _rel(got["y"], want) <= REL
        if case["rules"] == "default":
            calls = {op: n for op, n in got["collectives"].items() if n}
            assert calls == ({} if mesh[1] == 1 else
                             {"c10d_functional.all_reduce": 1}), calls


@pytest.mark.parametrize("mesh,case", _params("trainer"))
def test_trainer_matches_jax_and_one_device(runs, mesh, case):
    """The Trainer on the mesh ("direct" mode, its own init drawn on every
    rank): step 0's loss against JAX's ``loss_fn`` on those params and
    the one-device Trainer's (rtol 1e-5), three steps' losses (rtol
    1e-4), its params after one step (``_params_close``) and AdamW mu
    (rtol = atol = 2e-4 where |g| >= 1e-5) against the one-device
    Trainer's."""
    got = _got(runs, mesh, case, "trainer")
    one = runs["refs"]["one"]["trainer"]
    assert got["mode"] == "direct"
    np.testing.assert_allclose(got["loss0"], one["jax_loss0"], rtol=REL)
    np.testing.assert_allclose(got["loss0"], one["loss0"], rtol=REL)
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=GRAD_REL)
    for path, want in one["params1"].items():
        g = one["mu1"][path] / (1 - B1)
        _params_close(got["params1"][path], want, g, R.OPT["lr"])
        cond = np.abs(g) >= ADAM_COND
        np.testing.assert_allclose(got["mu1"][path][cond],
                                   one["mu1"][path][cond], rtol=2e-4,
                                   atol=2e-4 * (1 - B1))


@pytest.mark.parametrize("mesh,case", _params("plan"))
def test_train_plan_matches_one_device(runs, mesh, case):
    """The train plan's step on the mesh from the carried params (MICRO
    microbatches under the default rules, one under FSDP) against the
    plan on a 1 x 1 mesh: the loss (rtol 1e-5), the params
    (``_params_close``)."""
    got = _got(runs, mesh, case, "plan")
    one = runs["refs"]["one"][f"plan{got['micro']}"]
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=REL)
    for path, want in one["params"].items():
        _params_close(got["params"][path], want,
                      one["mu"][path] / (1 - B1), R.OPT["lr"])


def _layout_cases():
    out = []
    for m, cs in CASES.items():
        for c in cs:
            for job in ("trainer", "plan"):
                if job in c["jobs"] and (job == "trainer"
                                         or c["rules"] != "default"):
                    out.append(pytest.param(
                        m, c, job, id=f"{m[0]}x{m[1]}-{R.case_name(c)}-{job}"))
    return out


@pytest.mark.parametrize("mesh,case,job", _layout_cases())
def test_block_shards_are_jax_devices_indices_map(runs, mesh, case, job):
    """Every rank's shard of the time-mix's and channel-mix's weights,
    and of their AdamW mu and nu, after a step is bitwise the slice of
    the gathered value JAX's ``devices_indices_map`` gives its mesh
    position for the same rules; the fallback report is JAX's."""
    want = runs["jax"][f"{mesh[0]}x{mesh[1]}/{case['rules']}"]
    ranks = runs["ranks"][mesh]
    full = ranks[0][R.case_name(case)][job]
    names = ({"params1": "params1", "mu1": "mu1", "nu1": "nu1"}
             if job == "trainer" else
             {"params": "params", "mu": "mu", "nu": None})
    checked = 0
    for r in ranks:
        where = str(r["coordinate"])
        mine = r[R.case_name(case)][job]
        for name, gathered_name in names.items():
            shards = mine[name + "_shards"]
            assert set(shards) == set(want["leaves"]), name
            for path, (shard, _) in shards.items():
                box = want["leaves"][path][where]
                if gathered_name is not None:
                    np.testing.assert_array_equal(
                        shard, _slice(full[gathered_name][path], box),
                        err_msg=f"rank {where} {name} {path}")
                else:
                    assert list(shard.shape) == [b - a for a, b in box]
                checked += 1
    assert checked == len(ranks) * len(names) * len(want["leaves"])
    assert full["fallbacks"] == want["fallbacks"]


@pytest.mark.parametrize("mesh,case", _params("serve"))
def test_prefill_and_decode_plans_match_jax(runs, mesh, case):
    """The prefill plan's last logits and gathered state, and each decode
    step's logits and the state after the last step, against JAX's
    single-device prefill and decode steps in the factored mode (1e-5 of
    max |JAX|)."""
    got = _got(runs, mesh, case, "serve")
    ref = runs["refs"]["serve"]
    assert _rel(got["prefill_last"], ref["last"]) <= REL
    assert set(got["prefill_state"]) == set(ref["state"])
    for path, arr in got["prefill_state"].items():
        assert _rel(arr, ref["state"][path]) <= REL, path
    assert len(got["decode"]) == R.SERVE["steps"]
    for t, (g, w) in enumerate(zip(got["decode"], ref["steps"])):
        assert _rel(g, w) <= REL, t
    for path, arr in got["decode_state"].items():
        assert _rel(arr, ref["final"][path]) <= REL, path


@pytest.mark.parametrize("mesh,case", _params("serve"))
def test_decode_state_layout_is_jaxs(runs, mesh, case):
    """The prefill plan's state and every decode step's are placed as the
    plans say, and every rank's shard of the last step's state is the
    slice of the gathered state that JAX's decode plan gives its mesh
    position: the WKV state's batch over "data", its heads replicated
    over "model"."""
    want = runs["jax"][f"{mesh[0]}x{mesh[1]}/{case['rules']}"]["state"]
    full = _got(runs, mesh, case, "serve")["decode_state"]
    for r in runs["ranks"][mesh]:
        got = r[R.case_name(case)]["serve"]
        for record in [got["prefill_layout"]] + got["decode_layout"]:
            for path, (_, placed, plan) in record.items():
                assert placed == plan, (path, placed, plan)
        last = got["decode_layout"][-1]
        assert set(last) == set(want)
        for path, (shard, placed, _) in last.items():
            box = want[path][str(r["coordinate"])]
            np.testing.assert_array_equal(shard, _slice(full[path], box))
            if path.endswith("wkv"):
                H = full[path].shape[2]
                assert box[2] == [0, H] and "Shard(dim=2)" not in placed


@pytest.mark.parametrize("kind", ["generate", "generate_kernel"])
@pytest.mark.parametrize("mesh,case", _params("serve"))
def test_generate_on_the_mesh_is_one_devices(runs, mesh, case, kind):
    """``generate`` with params placed on the mesh, through a factored
    model (the plans') and the default kernel-mode one, returns on every
    rank the one-device ``generate``'s tokens (a token whose one-device
    top-2 margin is under TIE may be either); the kernel-mode prefill
    calls the WKV6 kernel's wrapper once a layer on every rank."""
    want, margins = runs["refs"]["one"][kind]
    layers = get_smoke_arch(R.ARCH).num_layers
    for res in runs["ranks"][mesh]:
        serve = res[R.case_name(case)]["serve"]
        got = serve[kind]
        assert got.shape == want.shape and got.dtype == np.int32
        differ = got != want
        if differ.any():
            first = np.argwhere(differ)[0]
            assert margins[tuple(first)] < TIE, (got, want, margins)
        assert serve["kernel_calls"] == layers
