"""The prefill and decode plans and ``generate`` on a model axis, for the
dense family, on the CPU: SPMD ranks over gloo
(``tests/torch_decode_axis_ranks.py``, one process a mesh position, one
torch thread each) on (1, 2), (2, 1) and (2, 2) meshes, held to the JAX
package and to the port's one-device ``generate``.

The cases run every branch of ``rules_for``'s ``kv_seq`` rule for a
decode shape: on (1, 2) llama3-8b SMOKE (4 heads over 1 KV head: the
cache's sequence over "model"), smollm-360m (4 over 2) and codeqwen1.5-7b
(4 over 4: head-sharded caches) and gemma3-12b (rings of 16 slots beside
a global layer, 4 over 2); on (2, 1) llama3-8b and gemma3-12b at batch 1
(the sequence over "data", a ring included); on (2, 2) llama3-8b at
batch 1 (the sequence over ("data", "model"), in mesh order). Decode
positions cross a shard's boundary (prompt 12, 32 slots, 8 steps), start
where some ranks' shards hold no valid slot (prompt 4 over 4 shards of
8) and wrap a ring (gemma3's prompt 20 over a window of 16).

  * Values: the prefill plan's last logits and gathered cache (with
    ``last_logit`` off, as the JAX package's plan, and on), the model's
    prefill of ``cache_len`` slots on the plan's placed params (the cache
    the decode steps take, as ``generate`` fills it), each decode step's
    logits and the gathered cache after the last step, against JAX's
    single-device
    ``prefill`` and ``decode_step`` on the same params (JAX-drawn,
    carried with ``models.params_from_jax``): within 1e-5 of max |JAX
    value| a leaf, ``tests/test_torch_decode.py``'s bar.
  * Layouts: every rank's shard of the prefill's logits and cache, and of
    the decode step's cache on entry and after every step (and of its
    logits), is bitwise the slice JAX's ``devices_indices_map`` gives
    that mesh position for the same rules (one subprocess of the JAX
    package on forced host devices), and its placements are
    ``sharding.rules.placements`` of the plan's sharding: a cache gathered
    on the way would show as a replicated placement and a whole local
    shard. The fallback reports and the ``kv_seq`` rule are JAX's.
  * ``generate`` on the mesh returns, on every rank, the port's
    one-device ``generate``'s tokens; at a step whose top-2 margin on one
    device is under ``TIE`` either token is accepted.
  * ``softmax_over_shards`` alone against ``torch.softmax`` over the full
    scores at 1e-6, with whole shards masked and the keys split over one
    and over two mesh dimensions.
  * ``sharding.rules.dim_range`` against ``devices_indices_map`` for every
    entry ``rules_for`` can give on (1, 2), (2, 1), (2, 2) and
    (pod 2, data 2, model 2) meshes.
"""
import itertools
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
from repro_torch.config import get_smoke_arch
from repro_torch.models import build_model, params_from_jax
from repro_torch.runtime.serve_loop import generate
from repro_torch.sharding.rules import dim_range
from torch_jax_state import no_jax_constrainer  # noqa: F401
import torch_decode_axis_ranks as R
from torch_threads import one_torch_thread  # noqa: F401

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
REL = 1e-5
TIE = 1e-4
COMBINE_TOL = 1e-6


def _case(arch, batch, prompt, steps):
    return dict(arch=arch, batch=batch, prompt=prompt, cache_len=32,
                steps=steps)


CASES = {
    (1, 2): [_case("llama3-8b", 2, 12, 8), _case("smollm-360m", 2, 12, 3),
             _case("codeqwen1.5-7b", 2, 12, 3),
             _case("gemma3-12b", 2, 20, 4)],
    (2, 1): [_case("llama3-8b", 1, 12, 8), _case("gemma3-12b", 1, 20, 4)],
    (2, 2): [_case("llama3-8b", 1, 4, 6)],
}
MESHES = tuple(CASES)
COMBINE_MESHES = ((1, 2), (2, 2))
ARCHS = sorted({c["arch"] for cs in CASES.values() for c in cs})
# the (pod, data, model) shapes dim_range is held to JAX on
RANGE_MESHES = ((1, 2), (2, 1), (2, 2), (2, 2, 2))

_LAYOUT_SCRIPT = r"""
import itertools, json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec
from repro.checkpoint.checkpoint import _flatten_with_paths
from repro.config import InputShape, get_smoke_arch
from repro.launch.steps import rules_for, shardings_for_tree
from repro.models import build_model, input_axes, input_specs
spec, range_meshes = json.loads(%r)

def boxes(sh, shape, coord):
    return {str(coord[d.id]): [[s.start or 0, n if s.stop is None else s.stop]
                               for s, n in zip(idx, shape)]
            for d, idx in sh.devices_indices_map(shape).items()}

out = {"cases": {}, "ranges": {}}
for (data, model), cases in spec:
    mesh = jax.make_mesh((data, model), ("data", "model"),
                         devices=jax.devices()[:data * model])
    coord = {d.id: list(map(int, i)) for i, d in np.ndenumerate(mesh.devices)}
    for case in cases:
        cfg = get_smoke_arch(case["arch"])
        m = build_model(cfg)
        b, P, L = case["batch"], case["prompt"], case["cache_len"]
        sds = jax.eval_shape(m.init, jax.random.key(0))
        res = {}
        for kind, n in (("prefill", P), ("decode", L)):
            shape = InputShape(kind, n, b, kind)
            rs = rules_for(cfg, shape, mesh)
            shardings_for_tree(rs, m.param_axes(), sds)
            bsds = input_specs(cfg, shape)
            bsh = shardings_for_tree(rs, input_axes(cfg, shape), bsds)
            if kind == "prefill":
                csds, caxes = m.cache_spec(b, P)
                csh = shardings_for_tree(rs, caxes, csds)
            else:
                csds, csh = bsds["cache"], bsh["cache"]
            res[kind] = {"cache": {
                path: boxes(sh, sd.shape, coord)
                for (path, sh), (_, sd) in zip(_flatten_with_paths(csh),
                                               _flatten_with_paths(csds))}}
            vshape = (b, cfg.padded_vocab_size)
            lsh = rs.sharding(("batch", "act_vocab"), vshape)
            res[kind].update(logits=boxes(lsh, vshape, coord),
                             fallbacks=rs.fallback_report(),
                             kv_seq=rs.rules.get("kv_seq"))
        out["cases"]["{}x{}/{}".format(data, model, case["arch"])] = res
for shape in range_meshes:
    axes = ("pod", "data", "model")[-len(shape):]
    n = int(np.prod(shape))
    mesh = jax.make_mesh(tuple(shape), axes, devices=jax.devices()[:n])
    coord = {d.id: dict(zip(axes, map(int, i)))
             for i, d in np.ndenumerate(mesh.devices)}
    for r in range(1, len(axes) + 1):
        for entry in itertools.combinations(axes, r):
            sh = NamedSharding(mesh, PartitionSpec(entry))
            got = {json.dumps(coord[d.id], sort_keys=True):
                   [idx[0].start or 0,
                    (idx[0].stop or 24) - (idx[0].start or 0)]
                   for d, idx in sh.devices_indices_map((24,)).items()}
            out["ranges"]["{}/{}".format(",".join(map(str, shape)),
                                         ",".join(entry))] = got
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


def _jax_reference(params_np, case):
    """JAX's single-device prefill (its last logits, its cache of
    ``cache_len`` slots) and ``steps`` decode steps teacher-forced on the
    case's tokens (each step's logits, the cache after the last)."""
    cfg = j_smoke(case["arch"])
    model = j_build_model(cfg)
    params = jax.tree.map(jnp.asarray, params_np)
    toks = R.case_tokens(get_smoke_arch(case["arch"]), case)
    P, L = case["prompt"], case["cache_len"]
    prefill = jax.jit(model.prefill, static_argnames="cache_len")
    logits, cache = prefill(params, jnp.asarray(toks[:, :P]), cache_len=L)
    ref = {"last": np.asarray(logits[:, -1]),
           "cache": jax.tree.map(np.asarray, cache), "steps": []}
    step = jax.jit(model.decode_step)
    for t in range(case["steps"]):
        pos = P + t
        logits, cache = step(params, jnp.asarray(toks[:, pos:pos + 1]),
                             jnp.asarray(pos, jnp.int32), cache)
        ref["steps"].append(np.asarray(logits[:, -1]))
    ref["final"] = jax.tree.map(np.asarray, cache)
    return ref


def _one_device_generate(params_np, case):
    """The port's one-device ``generate`` on the CPU, and each of its
    tokens' top-2 margin (the same prefill and steps, teacher-forced on
    its own tokens)."""
    cfg = get_smoke_arch(case["arch"])
    model = build_model(cfg)
    params = params_from_jax(params_np, "cpu")
    toks = R.case_tokens(cfg, case)[:, :case["prompt"]]
    L = case["cache_len"]
    got = generate(model, params, toks, R.GEN_STEPS, cache_len=L)
    logits, cache = model.prefill(params, torch.as_tensor(toks), cache_len=L)
    margins = []
    for t in range(R.GEN_STEPS):
        top = torch.topk(logits[:, -1], 2).values
        margins.append((top[:, 0] - top[:, 1]).numpy())
        if t + 1 < R.GEN_STEPS:
            logits, cache = model.decode_step(
                params, torch.as_tensor(got[:, t:t + 1]),
                toks.shape[1] + t, cache)
    return got, np.stack(margins, axis=1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh's ranks (all started at once), the JAX layouts beside
    them, and, while they run, the JAX references and the one-device
    ``generate``s in this process."""
    base = tmp_path_factory.mktemp("decode_axis")
    params_np = {a: _np_tree(j_build_model(j_smoke(a)).init(
        jax.random.key(0))) for a in ARCHS}
    torch.save(params_np, base / "params.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = []
    for data, model in MESHES:
        out = base / f"{data}x{model}"
        out.mkdir()
        port, world = _free_port(), data * model
        jobs = "serve,combine" if (data, model) in COMBINE_MESHES else "serve"
        for r in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, str(HERE / "torch_decode_axis_ranks.py"),
                 "--rank", str(r), "--world", str(world), "--port",
                 str(port), "--data", str(data), "--device", "cpu",
                 "--params", str(base / "params.pt"), "--cases",
                 json.dumps(CASES[data, model]), "--jobs", jobs,
                 "--out", str(out)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    jenv = dict(env, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        env.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"))
    spec = json.dumps([[[list(m), CASES[m]] for m in MESHES],
                       [list(m) for m in RANGE_MESHES]])
    jax_proc = subprocess.Popen([sys.executable, "-c", _LAYOUT_SCRIPT % spec],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=jenv)
    refs, gens = {}, {}
    for mesh, cases in CASES.items():
        for case in cases:
            name = R.case_name(case)
            if name not in refs:
                refs[name] = _jax_reference(params_np[case["arch"]], case)
                gens[name] = _one_device_generate(params_np[case["arch"]],
                                                  case)
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
            "refs": refs, "gens": gens}


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / (np.abs(want).max() + 1e-9))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _slice(arr, box):
    return arr[tuple(slice(a, b) for a, b in box)]


def _cases():
    return [pytest.param(m, c, id=f"{m[0]}x{m[1]}-{c['arch']}")
            for m, cs in CASES.items() for c in cs]


@pytest.mark.parametrize("mesh,case", _cases())
def test_prefill_plan_matches_jax(runs, mesh, case):
    """The prefill plan's last logits and gathered cache (the prompt's
    slots), with ``last_logit`` off (the JAX package's plan) and on, and
    the model's prefill of ``cache_len`` slots on the plan's placed
    params, against JAX's single-device prefill with ``cache_len`` (the
    prompt's slots are its first ones)."""
    got = runs["ranks"][mesh][0][R.case_name(case)]
    ref = runs["refs"][R.case_name(case)]
    want = _flat(ref["cache"])
    for last in (True, False):
        assert _rel(got["prefill"][last]["logits"]["full"][""],
                    ref["last"]) <= REL
        cache = got["prefill"][last]["cache"]["full"]
        assert set(cache) == set(want)
        for path, arr in cache.items():
            assert arr.shape[2] == min(case["prompt"],
                                       want[path].shape[2]), path
            assert _rel(arr, want[path][:, :, :arr.shape[2]]) <= REL, path
    assert set(got["prefill_cache"]) == set(want)
    for path, arr in got["prefill_cache"].items():
        assert arr.shape == want[path].shape, path
        assert _rel(arr, want[path]) <= REL, path


@pytest.mark.parametrize("mesh,case", _cases())
def test_decode_plan_matches_jax(runs, mesh, case):
    """Each decode step's logits, and the gathered cache after the last
    step, against JAX's single-device decode steps from its prefill."""
    got = runs["ranks"][mesh][0][R.case_name(case)]["decode"]
    ref = runs["refs"][R.case_name(case)]
    assert len(got) == len(ref["steps"]) == case["steps"]
    for t, (g, w) in enumerate(zip(got, ref["steps"])):
        assert _rel(g["logits"]["full"][""], w) <= REL, t
    want = _flat(ref["final"])
    for path, arr in got[-1]["cache"]["full"].items():
        assert _rel(arr, want[path]) <= REL, path


def _records(res):
    """(what, the recorded tree, JAX's kind and entry) of every layout a
    case recorded."""
    yield "prefill logits", res["prefill"][True]["logits"], "prefill", \
        "logits"
    yield "prefill logits (all positions)", res["prefill"][False]["logits"], \
        "prefill", "logits"
    yield "prefill cache", res["prefill"][False]["cache"], "prefill", "cache"
    yield "prefill cache (last_logit)", res["prefill"][True]["cache"], \
        "prefill", "cache"
    yield "decode cache on entry", res["decode_entry"], "decode", "cache"
    for t, step in enumerate(res["decode"]):
        yield f"step {t} logits", step["logits"], "decode", "logits"
        yield f"step {t} cache", step["cache"], "decode", "cache"


@pytest.mark.parametrize("mesh,case", _cases())
def test_shards_are_jax_devices_indices_map(runs, mesh, case):
    """Every rank's own shard of the prefill's logits and cache and of the
    decode step's cache on entry and after each step (and its logits) is
    the slice of the gathered value JAX's ``devices_indices_map`` gives
    its mesh position, placed as the plan's sharding says."""
    name = R.case_name(case)
    jax_case = runs["jax"]["cases"][f"{mesh[0]}x{mesh[1]}/{case['arch']}"]
    ranks = runs["ranks"][mesh]
    for r, res in enumerate(ranks):
        where = str(res["coordinate"])
        mine = res[name]
        for (what, rec, kind, entry), (_, rec0, _, _) in zip(
                _records(mine), _records(ranks[0][name])):
            for path, shard in rec["local"].items():
                boxes = (jax_case[kind][entry] if entry == "logits"
                         else jax_case[kind][entry][path])
                np.testing.assert_array_equal(
                    shard, _slice(rec0["full"][path], boxes[where]),
                    err_msg=f"rank {r} {what} {path}")
                assert rec["placements"][path] == \
                    rec["plan_placements"][path], (r, what, path)


@pytest.mark.parametrize("mesh,case", _cases())
def test_fallbacks_and_kv_seq_are_jax(runs, mesh, case):
    """The prefill and decode plans' fallback reports and the decode
    plan's ``kv_seq`` rule are JAX's; a sequence-sharded cache holds
    its slots' share on each rank, never all of them."""
    got = runs["ranks"][mesh][0][R.case_name(case)]
    want = runs["jax"]["cases"][f"{mesh[0]}x{mesh[1]}/{case['arch']}"]
    assert got["prefill_fallbacks"] == want["prefill"]["fallbacks"]
    assert got["decode_fallbacks"] == want["decode"]["fallbacks"]
    kv_seq = want["decode"]["kv_seq"]
    assert got["kv_seq"] == (None if kv_seq is None else tuple(kv_seq))
    ways = 1
    for axis in got["kv_seq"] or ():
        ways *= dict(zip(("data", "model"), mesh))[axis]
    for r in runs["ranks"][mesh]:
        for step in r[R.case_name(case)]["decode"]:
            for path, shard in step["cache"]["local"].items():
                full = runs["ranks"][mesh][0][R.case_name(case)][
                    "decode_entry"]["full"][path]
                assert shard.shape[2] * ways == full.shape[2], path


@pytest.mark.parametrize("mesh,case", _cases())
def test_generate_on_the_mesh_is_one_devices(runs, mesh, case):
    """``generate`` with params placed on the mesh returns, on every rank,
    the one-device ``generate``'s tokens; a token whose one-device top-2
    margin is under TIE may be either (none is, for these seeds, unless
    the assertion says so)."""
    want, margins = runs["gens"][R.case_name(case)]
    for res in runs["ranks"][mesh]:
        got = res[R.case_name(case)]["generate"]
        assert got.shape == want.shape and got.dtype == np.int32
        differ = got != want
        if differ.any():
            first = np.argwhere(differ)[0]
            assert margins[tuple(first)] < TIE, (got, want, margins)


@pytest.mark.parametrize("mesh", COMBINE_MESHES)
@pytest.mark.parametrize("valid", R.COMBINE_VALID)
def test_softmax_over_shards_is_the_full_softmax(runs, mesh, valid):
    """``softmax_over_shards`` over keys split on every mesh dimension
    against ``torch.softmax`` over the full scores, on every rank; with 5
    valid keys of 16 whole shards are masked."""
    ranks = runs["ranks"][mesh]
    got0 = ranks[0]["combine"]
    scores, v = (torch.as_tensor(got0[k]) for k in ("scores", "v"))
    keep = torch.arange(scores.shape[-1]) < valid
    s = torch.where(keep, scores, torch.full_like(scores, -1e30))
    want = torch.einsum("bhql,blhk->bqhk", torch.softmax(s, dim=-1), v)
    for res in ranks:
        np.testing.assert_allclose(res["combine"][valid]["out"],
                                   want.numpy(), rtol=COMBINE_TOL,
                                   atol=COMBINE_TOL)
    masked = [res["combine"][valid]["masked_shard"] for res in ranks]
    assert any(masked) == (valid < scores.shape[-1])


@pytest.mark.parametrize("shape", RANGE_MESHES,
                         ids=lambda s: "x".join(map(str, s)))
def test_dim_range_is_devices_indices_map(runs, shape):
    """``dim_range`` of every entry of the mesh's axes (in mesh order) at
    every mesh position against JAX's ``devices_indices_map`` of a
    ``PartitionSpec`` of that entry over 24 rows."""
    axes = ("pod", "data", "model")[-len(shape):]
    mesh_shape = dict(zip(axes, shape))
    checked = 0
    for r in range(1, len(axes) + 1):
        for entry in itertools.combinations(axes, r):
            want = runs["jax"]["ranges"][
                "{}/{}".format(",".join(map(str, shape)), ",".join(entry))]
            for coord_json, box in want.items():
                coord = json.loads(coord_json)
                assert list(dim_range(mesh_shape, entry, coord, 24)) == box
                checked += 1
    assert checked == sum(len(list(itertools.combinations(axes, r)))
                          for r in range(1, len(axes) + 1)) * np.prod(shape)
