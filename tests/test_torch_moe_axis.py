"""The MoE family on a model axis, on the CPU: SPMD ranks over gloo
(``tests/torch_moe_axis_ranks.py``, one process a mesh position, one
torch thread each) on (1, 2), (2, 1) and (2, 2) meshes, held to the JAX
package and to the port's one-device paths, for qwen3-moe-30b-a3b SMOKE
(8 experts, top 2) and dbrx-132b SMOKE (4 experts, top 2) in float32,
with both dispatches ("onehot" and "sort"). The experts lie over
"model" (``models.moe.moe_apply_mesh``); params are JAX-drawn and carried
with ``models.params_from_jax`` except the Trainer's, which draws its
own on every rank and on one device alike.

  * Values: the step-0 loss (rtol 1e-5) and every leaf's gradient of
    ``loss_fn`` on the mesh against ``jax.value_and_grad`` of JAX's
    ``loss_fn``: the MoE leaves (the router among them) within 1e-5 of
    max |JAX| a leaf, the others within 1e-4 (the one-device bar of
    ``tests/test_torch_train_loss.py``); the MoE block alone (its input
    x and ``sum(y * r) + AUX_W * aux``): y, and the gradients of x (the
    block's input) and of the router, within 1e-5 of max |JAX|, aux
    within 1e-6. A gradient entered once a rank of the model axis would
    show as the router's gradient twice JAX's. The ``Trainer``'s step-0
    loss against JAX's and the one-device Trainer's (rtol 1e-5), its
    three losses (rtol 1e-4), its params and AdamW mu after one step
    against the one-device Trainer's; the train plan at two microbatches
    (each routes its own chunks) against the one-device plan. The prefill
    plan's last logits and gathered cache and each decode step's logits
    against JAX's single-device ``prefill`` and ``decode_step`` within
    1e-5 of max |JAX value|; ``generate`` equal to one device's, a token
    whose one-device top-2 margin is under TIE accepted either way.
  * The chunk that spans data shards: on (2, 1) and (2, 2) the block
    alone on 2 x 8 tokens routes one chunk over both row shards (the
    experts gathered, no chunk routed alone), and drops pairs; the
    train steps (2 x 8 tokens a row shard of a 32-token chunk) and each
    decode step at batch 2 (one token a row shard) route so too. 2 x
    1,024 tokens hold a whole chunk a row shard: each routes alone, with
    one all-reduce of the auxiliary loss over "data" and one of the
    combine over "model" (when it has 2 ranks), nothing gathered.
  * FSDP: on (2, 2) the rules ``rules_for`` gives the full MoE configs
    (``embed`` and ``fsdp_embed`` over "data", ``expert_mlp`` None): the
    gradients, the block alone, the train plan and serving as above.
  * The fallback: on (1, 2) ``{"experts": None}`` (experts replicated,
    nothing summed over "model"): the same values.
  * Layouts: every rank's shard of the router, ``wi``, ``wg`` and ``wo``,
    and of their AdamW mu and nu after a step (the Trainer's, and the
    FSDP and replicated plans'), is bitwise the slice JAX's
    ``devices_indices_map`` gives that mesh position for the same rules
    (one subprocess of the JAX package on forced host devices); the
    fallback reports are JAX's.
  * Routing: every rank's expert indices and kept pairs equal those of
    every rank with the same rows, and, gathered over the row shards,
    the one-device routing's.
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
from repro.models import moe as j_moe
from repro_torch.config import OptimizerConfig, get_smoke_arch
from repro_torch.data.loader import device_batch
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import steps
from repro_torch.models import build_model, moe, params_from_jax
from repro_torch.optimizer import adamw
from repro_torch.runtime.serve_loop import generate
from repro_torch.runtime.train_loop import Trainer
from torch_jax_state import no_jax_constrainer  # noqa: F401
import torch_moe_axis_ranks as R

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
REL = 1e-5
GRAD_REL = 1e-4
AUX_TOL = 1e-6
TIE = 1e-4
B1 = OptimizerConfig().b1
ADAM_COND = 1e-5        # tests/test_torch_launch_train.py's
ALL_JOBS = ["grad", "layer", "trainer", "plan", "serve"]


def _cases(rules, jobs):
    return [dict(arch=a, dispatch=d, rules=rules, jobs=jobs)
            for a in R.ARCHS for d in R.DISPATCHES]


CASES = {
    (1, 2): _cases("default", ALL_JOBS)
    + _cases("replicated", ["layer", "plan", "serve"]),
    (2, 1): _cases("default", ALL_JOBS),
    (2, 2): _cases("default", ALL_JOBS)
    + _cases("fsdp", ["grad", "layer", "plan", "serve"]),
}
MESHES = tuple(CASES)

_LAYOUT_SCRIPT = r"""
import json
import jax, numpy as np
from repro.config import InputShape, get_smoke_arch
from repro.launch.steps import rules_for, shardings_for_tree
from repro.models import build_model
spec, rules = json.loads(%r)
SHAPE = InputShape("tiny", %d, %d, "train")
out = {}
for (data, model), names in spec:
    mesh = jax.make_mesh((data, model), ("data", "model"),
                         devices=jax.devices()[:data * model])
    coord = {d.id: list(map(int, i)) for i, d in np.ndenumerate(mesh.devices)}
    for arch, name in names:
        cfg = get_smoke_arch(arch)
        m = build_model(cfg)
        rs = rules_for(cfg, SHAPE, mesh, rules[name])
        sds = jax.eval_shape(m.init, jax.random.key(0))
        psh = shardings_for_tree(rs, m.param_axes(), sds)
        leaves = {}
        for leaf, sh in psh["blocks"]["p0"]["moe"].items():
            shape = sds["blocks"]["p0"]["moe"][leaf].shape
            leaves["blocks/p0/moe/" + leaf] = {
                str(coord[d.id]): [[s.start or 0, n if s.stop is None
                                    else s.stop] for s, n in zip(idx, shape)]
                for d, idx in sh.devices_indices_map(shape).items()}
        out["{}x{}/{}/{}".format(data, model, arch, name)] = {
            "leaves": leaves, "fallbacks": rs.fallback_report()}
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


def _jax_model(arch, dispatch):
    return j_build_model(j_smoke(arch), moe_dispatch=dispatch)


def _jax_grads(params, arch, dispatch):
    """JAX's single-device loss and every gradient of ``loss_fn``."""
    model = _jax_model(arch, dispatch)
    batch = {k: jnp.asarray(v) for k, v in
             R.batch_tokens(get_smoke_arch(arch)).items()}
    loss, grads = jax.jit(jax.value_and_grad(model.loss_fn))(params, batch)
    return float(loss), _flat(grads)


def _jax_layer(params, arch, dispatch):
    """JAX's moe_apply alone on each of LAYER_SHAPES' inputs: y, aux and
    the gradients of sum(y * r) + AUX_W * aux by x and the router."""
    cfg = j_smoke(arch)
    p = jax.tree.map(lambda t: t[0], params["blocks"]["p0"]["moe"])
    out = {}
    for name, shape in R.LAYER_SHAPES.items():
        x, r = R.layer_input(get_smoke_arch(arch),
                             np.asarray(p["router"]), shape)

        def f(x, router):
            y, aux = j_moe.moe_apply(dict(p, router=router), x, cfg,
                                     dispatch)
            return jnp.sum(y * r) + R.AUX_W * aux, (y, aux)
        (_, (y, aux)), (gx, gr) = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(jnp.asarray(x), p["router"])
        out[name] = {"y": np.asarray(y), "aux": float(aux),
                     "grad_x": np.asarray(gx), "grad_router": np.asarray(gr)}
    return out


def _one_device_routing(params_np, arch):
    """The port's one-device experts and kept pairs of each layer input."""
    cfg = get_smoke_arch(arch)
    p = {k: torch.as_tensor(v[0]) for k, v in
         params_np["blocks"]["p0"]["moe"].items()}
    out = {}
    for name, shape in R.LAYER_SHAPES.items():
        x, _ = R.layer_input(cfg, params_np["blocks"]["p0"]["moe"]["router"]
                             [0], shape)
        flat = torch.as_tensor(x).reshape(-1, cfg.d_model)
        experts = torch.cat([moe._route(p, flat[sl], cfg)[1]
                             for sl in moe._chunks(flat.shape[0])])
        out[name] = (experts.numpy(),
                     moe.kept_pairs(p, torch.as_tensor(x), cfg).numpy())
    return out


def _jax_serve(params, arch, dispatch):
    """JAX's single-device prefill (its last logits and cache of
    cache_len slots) and decode steps teacher-forced on the case's
    tokens."""
    model = _jax_model(arch, dispatch)
    toks = R.serve_tokens(get_smoke_arch(arch))
    P, L = R.SERVE["prompt"], R.SERVE["cache_len"]
    prefill = jax.jit(model.prefill, static_argnames="cache_len")
    logits, cache = prefill(params, jnp.asarray(toks[:, :P]), cache_len=L)
    ref = {"last": np.asarray(logits[:, -1]), "cache": _flat(cache),
           "steps": []}
    step = jax.jit(model.decode_step)
    for t in range(R.SERVE["steps"]):
        pos = P + t
        logits, cache = step(params, jnp.asarray(toks[:, pos:pos + 1]),
                             jnp.asarray(pos, jnp.int32), cache)
        ref["steps"].append(np.asarray(logits[:, -1]))
    ref["final"] = _flat(cache)
    return ref


def _one_device(params_np, arch, dispatch, work: Path):
    """The port's one-device Trainer (its own init), the train plan from
    the carried params at 1 and MICRO microbatches, and ``generate``
    with each token's top-2 margin, on the CPU."""
    cfg = get_smoke_arch(arch)
    out = {}
    with Trainer(cfg, R.train_config(work / f"{arch}-{dispatch}"),
                 device="cpu", moe_dispatch=dispatch) as tr:
        s0 = tr.init_state()
        batch = tr.loader.batch(0)
        init = _nest({k: R.full(t) for k, t in R.flatten_with_paths(s0[0])})
        jax_loss0 = float(_jax_model(arch, dispatch).loss_fn(
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
                                     microbatches=micro,
                                     moe_dispatch=dispatch)
        params = params_from_jax(params_np, "cpu")
        (new, state), m = plan.step_fn((params, adamw.init(opt, params)),
                                       R.batch_tokens(cfg))
        out[f"plan{micro}"] = {
            "loss": float(m["loss"]),
            "params": {k: R.full(t) for k, t in R.flatten_with_paths(new)},
            "mu": {k: R.full(t) for k, t in R.flatten_with_paths(state.mu)}}
    model = build_model(cfg, moe_dispatch=dispatch)
    params = params_from_jax(params_np, "cpu")
    toks = R.serve_tokens(cfg)[:, :R.SERVE["prompt"]]
    L = R.SERVE["cache_len"]
    got = generate(model, params, toks, R.GEN_STEPS, cache_len=L)
    logits, cache = model.prefill(params, torch.as_tensor(toks), cache_len=L)
    margins = []
    for t in range(R.GEN_STEPS):
        top = torch.topk(logits[:, -1], 2).values
        margins.append((top[:, 0] - top[:, 1]).numpy())
        if t + 1 < R.GEN_STEPS:
            logits, cache = model.decode_step(
                params, torch.as_tensor(got[:, t:t + 1]), toks.shape[1] + t,
                cache)
    out["generate"] = (got, np.stack(margins, axis=1))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh's ranks (all started at once), the JAX layouts beside
    them, and, while they run, the JAX references and the port's
    one-device runs in this process."""
    base = tmp_path_factory.mktemp("moe_axis")
    params_np = {a: _np_tree(j_build_model(j_smoke(a)).init(
        jax.random.key(0))) for a in R.ARCHS}
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
                [sys.executable, str(HERE / "torch_moe_axis_ranks.py"),
                 "--rank", str(r), "--world", str(world), "--port",
                 str(port), "--data", str(data), "--device", "cpu",
                 "--params", str(base / "params.pt"), "--cases",
                 json.dumps(CASES[data, model]), "--out", str(out)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    jenv = dict(env, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        env.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=4"))
    names = [[list(m), sorted({(c["arch"], c["rules"]) for c in CASES[m]})]
             for m in MESHES]
    spec = json.dumps([names, R.RULES])
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _LAYOUT_SCRIPT % (spec, R.SHAPE.seq_len,
                                                 R.SHAPE.global_batch)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=jenv)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        refs = {}
        for arch in R.ARCHS:
            jparams = jax.tree.map(jnp.asarray, params_np[arch])
            refs[arch] = {"routing": _one_device_routing(params_np[arch],
                                                         arch)}
            for d in R.DISPATCHES:
                refs[arch, d] = {
                    "grads": _jax_grads(jparams, arch, d),
                    "layer": _jax_layer(jparams, arch, d),
                    "serve": _jax_serve(jparams, arch, d),
                    "one": _one_device(params_np[arch], arch, d,
                                       base / "single")}
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


def _params(jobs=None, rules=None):
    return [pytest.param(m, c, id=f"{m[0]}x{m[1]}-{R.case_name(c)}")
            for m, cs in CASES.items() for c in cs
            if (jobs is None or jobs in c["jobs"])
            and (rules is None or c["rules"] in rules)]


def _got(runs, mesh, case, job, rank=0):
    return runs["ranks"][mesh][rank][R.case_name(case)][job]


def _is_moe(path: str) -> bool:
    return "/moe/" in path


@pytest.mark.parametrize("mesh,case", _params("grad"))
def test_loss_and_gradients_match_jax(runs, mesh, case):
    """loss_fn's value (rtol 1e-5) and every leaf's gradient on the mesh
    against ``jax.value_and_grad`` of JAX's ``loss_fn``: the MoE leaves
    within 1e-5 of max |JAX|, the others within 1e-4."""
    got = _got(runs, mesh, case, "grad")
    loss, grads = runs["refs"][case["arch"], case["dispatch"]]["grads"]
    np.testing.assert_allclose(got["loss"], loss, rtol=REL)
    assert set(got["grads"]) == set(grads)
    for path, want in grads.items():
        bar = REL if _is_moe(path) else GRAD_REL
        assert _rel(got["grads"][path], want) <= bar, (
            path, _rel(got["grads"][path], want))


@pytest.mark.parametrize("mesh,case", _params("layer"))
@pytest.mark.parametrize("shape", sorted(R.LAYER_SHAPES))
def test_moe_block_alone_matches_jax(runs, mesh, case, shape):
    """The MoE block alone on crowded inputs: y and the gradients of its
    input x and of the router within 1e-5 of max |JAX|, aux within 1e-6;
    the capacity drops pairs; y comes back placed as the rows."""
    got = _got(runs, mesh, case, "layer")[shape]
    want = runs["refs"][case["arch"], case["dispatch"]]["layer"][shape]
    for key in ("y", "grad_x", "grad_router"):
        assert _rel(got[key], want[key]) <= REL, (key, _rel(got[key],
                                                            want[key]))
    assert abs(got["aux"] - want["aux"]) <= AUX_TOL
    b, s = R.LAYER_SHAPES[shape]
    K = get_smoke_arch(case["arch"]).moe.top_k
    kept = sum(int(r[R.case_name(case)]["layer"][shape]["kept"].sum())
               for r in runs["ranks"][mesh] if r["coordinate"][1] == 0)
    assert kept < b * s * K                               # drops
    rows = "Shard(dim=0)" if mesh[0] > 1 else "Replicate()"
    assert got["y_placements"] == f"[{rows}, Replicate()]"


@pytest.mark.parametrize("mesh,case", _params("layer"))
@pytest.mark.parametrize("shape", sorted(R.LAYER_SHAPES))
def test_routing_is_every_ranks_and_one_devices(runs, mesh, case, shape):
    """Every rank's expert indices and kept pairs equal those of every
    rank with the same rows; gathered over the row shards in order, the
    one-device routing's."""
    ranks = runs["ranks"][mesh]
    by_rows = {}
    for r in ranks:
        g = r[R.case_name(case)]["layer"][shape]
        by_rows.setdefault(r["coordinate"][0], []).append(
            (g["experts"], g["kept"]))
    for same in by_rows.values():
        for experts, kept in same[1:]:
            np.testing.assert_array_equal(experts, same[0][0])
            np.testing.assert_array_equal(kept, same[0][1])
    want_e, want_k = runs["refs"][case["arch"]]["routing"][shape]
    np.testing.assert_array_equal(
        np.concatenate([by_rows[i][0][0] for i in sorted(by_rows)]), want_e)
    np.testing.assert_array_equal(
        np.concatenate([by_rows[i][0][1] for i in sorted(by_rows)]), want_k)


@pytest.mark.parametrize("mesh,case", _params("layer"))
def test_a_chunk_routes_whole_across_data_shards(runs, mesh, case):
    """On a mesh whose "data" axis shards the rows, the 16-token block
    routes its one chunk across both row shards (no chunk routed alone:
    the experts gathered) and the 2 x 1,024 one routes each row shard's
    whole chunk alone, its only all-reduces the auxiliary loss's over
    "data" and the combine's over "model" where the experts split it; on
    (1, 2) every chunk is local."""
    data, model = mesh
    split = model > 1 and case["rules"] != "replicated"
    for r in runs["ranks"][mesh]:
        calls = r[R.case_name(case)]["layer"]
        if data > 1:
            assert calls["span"]["calls"]["route"] == 0
            assert calls["whole"]["calls"] == {
                "route": 1, "all_reduce": 1 + split}
        else:
            assert calls["span"]["calls"] == {"route": 1,
                                              "all_reduce": int(split)}
            assert calls["whole"]["calls"] == {"route": 2,
                                               "all_reduce": int(split)}


@pytest.mark.parametrize("mesh,case", _params("trainer"))
def test_trainer_matches_jax_and_one_device(runs, mesh, case):
    """The Trainer on the mesh (its own init, drawn on every rank): step
    0's loss against JAX's ``loss_fn`` on those params and the one-device
    Trainer's (rtol 1e-5), three steps' losses (rtol 1e-4), its params
    after one step (``_params_close``) and AdamW mu (rtol = atol = 2e-4
    where |g| >= 1e-5) against the one-device Trainer's."""
    got = _got(runs, mesh, case, "trainer")
    one = runs["refs"][case["arch"], case["dispatch"]]["one"]["trainer"]
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


@pytest.mark.parametrize("mesh,case", _params("plan"))
def test_train_plan_matches_one_device(runs, mesh, case):
    """The train plan's step on the mesh from the carried params (MICRO
    microbatches under the default rules, one under FSDP and the
    replicated experts) against the plan on a 1 x 1 mesh: the loss
    (rtol 1e-5), the params (``_params_close``)."""
    got = _got(runs, mesh, case, "plan")
    one = runs["refs"][case["arch"], case["dispatch"]]["one"][
        f"plan{got['micro']}"]
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
def test_moe_shards_are_jax_devices_indices_map(runs, mesh, case, job):
    """Every rank's shard of the router, wi, wg and wo, and of their
    AdamW mu and nu, after a step is bitwise the slice of the gathered
    value JAX's ``devices_indices_map`` gives its mesh position for the
    same rules; the experts lie over "model" (not under the replicated
    rule), and the fallback report is JAX's."""
    want = runs["jax"][f"{mesh[0]}x{mesh[1]}/{case['arch']}/{case['rules']}"]
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
            for path, (shard, placed) in shards.items():
                box = want["leaves"][path][where]
                if gathered_name is not None:
                    np.testing.assert_array_equal(
                        shard, _slice(full[gathered_name][path], box),
                        err_msg=f"rank {where} {name} {path}")
                else:
                    assert list(shard.shape) == [b - a for a, b in box]
                if path.endswith("/wi"):
                    split = case["rules"] != "replicated" and mesh[1] > 1
                    assert ("Shard(dim=1)" in placed.split(", ")[-1]) == \
                        split, placed
                checked += 1
    assert checked == len(ranks) * len(names) * 4
    assert full["fallbacks"] == want["fallbacks"]


@pytest.mark.parametrize("mesh,case", _params("serve"))
def test_prefill_and_decode_plans_match_jax(runs, mesh, case):
    """The prefill plan's last logits and gathered cache (the prompt's
    slots), and each decode step's logits (batch 2: on a "data" axis one
    token a row shard, a chunk across them) and the cache after the last
    step, against JAX's single-device prefill and decode steps; every
    step's cache placed as the decode plan says."""
    got = _got(runs, mesh, case, "serve")
    ref = runs["refs"][case["arch"], case["dispatch"]]["serve"]
    assert _rel(got["prefill_last"], ref["last"]) <= REL
    assert set(got["prefill_cache"]) == set(ref["cache"])
    for path, arr in got["prefill_cache"].items():
        want = ref["cache"][path][:, :, :arr.shape[2]]
        assert _rel(arr, want) <= REL, path
    assert len(got["decode"]) == R.SERVE["steps"]
    for t, (g, w) in enumerate(zip(got["decode"], ref["steps"])):
        assert _rel(g, w) <= REL, t
    for path, arr in got["decode_cache"].items():
        assert _rel(arr, ref["final"][path]) <= REL, path
    for r in runs["ranks"][mesh]:
        for path, (placed, plan) in r[R.case_name(case)]["serve"][
                "cache_placements"].items():
            assert placed == plan, (path, placed, plan)


@pytest.mark.parametrize("mesh,case", _params("serve"))
def test_generate_on_the_mesh_is_one_devices(runs, mesh, case):
    """``generate`` with params placed on the mesh returns, on every rank,
    the one-device ``generate``'s tokens; a token whose one-device top-2
    margin is under TIE may be either."""
    want, margins = runs["refs"][case["arch"], case["dispatch"]]["one"][
        "generate"]
    for res in runs["ranks"][mesh]:
        got = res[R.case_name(case)]["serve"]["generate"]
        assert got.shape == want.shape and got.dtype == np.int32
        differ = got != want
        if differ.any():
            first = np.argwhere(differ)[0]
            assert margins[tuple(first)] < TIE, (got, want, margins)
