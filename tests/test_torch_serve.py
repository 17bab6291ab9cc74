"""The serving slice as a whole: the port's RolloutEngine against JAX's.

Both engines get the same converted weights and the same six text
requests over three slots (paged pool, prefix cache on, greedy
decoding).  The prompts share a four-block prefix and two of them repeat
an earlier prompt, so the cold, suffix-hit and full-hit admissions all
occur.  The port must give the same completion tokens, finish reasons
and prefix hit/miss block counts; inside the port, prefix cache on/off
and the kernel/plain KV layouts must give the same tokens.

Also checked here: the package imports nothing of JAX or of ``repro``
(in a subprocess, since this process has JAX loaded), entry points
default to the card and raise without one, and the card-only end-to-end
check (marked ``gpu``) that runs the kernels on a CUDA device.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.configs import sdar_8b as tcfgs  # noqa: E402
from repro_torch.models.model import BlockDiffLM as TModel  # noqa: E402
from repro_torch.serving.api import GenerationConfig as TGen  # noqa: E402
from repro_torch.serving.api import SamplingParams as TParams  # noqa: E402
from repro_torch.serving.engine import RolloutEngine as TEngine  # noqa: E402
from repro_torch.serving.server import ModelServer as TServer  # noqa: E402

try:  # the machine with the card has the port but no JAX
    import jax

    from repro.configs import sdar_8b as jcfgs
    from repro.models.model import BlockDiffLM as JModel
    from repro.serving.api import GenerationConfig as JGen
    from repro.serving.api import SamplingParams as JParams
    from repro.serving.engine import RolloutEngine as JEngine
    from repro.serving.server import ModelServer as JServer
except ImportError:
    jax = None
needs_jax = pytest.mark.skipif(jax is None,
                               reason="needs JAX and the reference package")

ROOT = Path(__file__).resolve().parents[1]
PREFIX = "Q: solve it.\nA:"          # BOS + 15 bytes = 4 blocks of 4
PROMPTS = [PREFIX + s for s in ("1+1=?", "2+3=?", "1+1=?", "7*8=?",
                                "2+3=?", "9-4=?")]
MAX_LEN, S_MAX, SLOTS, BUDGET = 48, 4, 3, 3


def _gen_kw():
    return dict(max_len=MAX_LEN, s_max=S_MAX, n_slots=SLOTS,
                prefix_cache=True)


def _outs(engine, params_cls):
    """(uid, token ids, finish reason, gen blocks) per request.  The ids
    are copied as each output arrives: on the CPU the JAX engine's ids
    are views of the pool buffer that its next tick donates and
    overwrites."""
    for p in PROMPTS:
        engine.submit(p, params=params_cls(max_new_blocks=BUDGET))
    return sorted((o.uid, np.array(o.token_ids), o.finish_reason,
                   o.gen_blocks) for o in engine.stream())


@pytest.fixture(scope="module")
def jax_weights():
    jm = JModel(jcfgs.smoke_config(attn_impl="pallas"))
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, convert.params_from_jax(jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module")
def port_params():
    """The port's own seeded init (no JAX needed)."""
    return TModel(tcfgs.smoke_config(), device="cpu").init(0)


@pytest.fixture(scope="module")
def jax_run(jax_weights):
    jm, jp, _ = jax_weights
    eng = JEngine(jm, JServer(jp), JGen(cache="paged", kernel="pallas",
                                        **_gen_kw()))
    return _outs(eng, JParams), eng.stats


def _port(params, kernel="cuda", prefix_cache=True):
    tm = TModel(tcfgs.smoke_config(attn_impl="cuda"), device="cpu")
    kw = {**_gen_kw(), "prefix_cache": prefix_cache}
    eng = TEngine(tm, TServer(params), TGen(kernel=kernel, **kw))
    return _outs(eng, TParams), eng


@needs_jax
def test_engine_matches_jax(jax_weights, jax_run):
    j_outs, j_stats = jax_run
    t_outs, eng = _port(jax_weights[2])
    assert len(t_outs) == len(j_outs) == len(PROMPTS)
    for (ua, ids_a, fa, ga), (ub, ids_b, fb, gb) in zip(t_outs, j_outs):
        assert (ua, fa, ga) == (ub, fb, gb)
        np.testing.assert_array_equal(ids_a, ids_b)
    assert eng.stats.prefix_hit_blocks == j_stats.prefix_hit_blocks
    assert eng.stats.prefix_miss_blocks == j_stats.prefix_miss_blocks
    paths = eng.scheduler.stats.admit_paths
    assert paths["cold"] and paths["suffix_prefill"] and paths["full_hit"]


@pytest.mark.parametrize("kernel,prefix_cache", [("cuda", False),
                                                 ("ref", True)])
def test_port_tokens_invariant(port_params, kernel, prefix_cache):
    base, _ = _port(port_params)
    other, eng = _port(port_params, kernel=kernel,
                       prefix_cache=prefix_cache)
    for a, b in zip(base, other):
        np.testing.assert_array_equal(a[1], b[1])
    if not prefix_cache:
        assert eng.stats.prefix_hit_blocks == 0


def test_port_outputs_own_their_tokens(port_params):
    """Outputs held across later ticks keep their tokens (the port copies
    each completion out of the pool)."""
    tm = TModel(tcfgs.smoke_config(attn_impl="cuda"), device="cpu")
    eng = TEngine(tm, TServer(port_params), TGen(**_gen_kw()))
    for p in PROMPTS:
        eng.submit(p, params=TParams(max_new_blocks=BUDGET))
    held = []
    for o in eng.stream():
        held.append((o, o.token_ids.copy()))
    for o, ids in held:
        np.testing.assert_array_equal(o.token_ids, ids)


def test_package_imports_no_jax_and_no_reference():
    code = textwrap.dedent("""
        import importlib, importlib.abc, pkgutil, sys

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for n in names:
            importlib.import_module(n)
        import chip_smoke
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "repro")]
        assert not bad, bad
        print(len(names))
    """)
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT)])}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 20


def test_entry_points_refuse_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.launch import serve
    from repro_torch.kernels import build
    with pytest.raises(RuntimeError, match="CUDA"):
        TModel(tcfgs.smoke_config())
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "sdar-8b", "--smoke"])
    with pytest.raises(RuntimeError, match="CUDA"):
        build.load()


def test_launcher_runs_on_cpu_when_asked(capsys):
    from repro_torch.launch import serve
    outs = serve.main(["--arch", "sdar-8b", "--smoke", "--device", "cpu",
                       "--requests", "3", "--max-len", "32", "--s-max",
                       "2", "--max-new-blocks", "2"])
    assert len(outs) == 3
    assert "[engine] 3 rollouts" in capsys.readouterr().out


@pytest.mark.gpu
def test_card_engine_matches_plain_path(port_params):
    """On a CUDA card: the kernel path and the plain path give the same
    greedy tokens, and every kernel of the path launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import block_diff_attn, paged_attn
    dev = torch.device("cuda")
    params = {k: (v.to(dev) if torch.is_tensor(v) else
                  [{n: t.to(dev) for n, t in lp.items()} for lp in v])
              for k, v in port_params.items()}
    runs = []
    for impl, kernel in (("cuda", "cuda"), ("chunked", "ref")):
        tm = TModel(tcfgs.smoke_config(attn_impl=impl), device=dev)
        eng = TEngine(tm, TServer(params), TGen(kernel=kernel,
                                                **_gen_kw()))
        runs.append(_outs(eng, TParams))
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a[1], b[1])
    assert block_diff_attn.block_diff_attention.launches > 0
    assert paged_attn.paged_decode_attention.launches > 0
    assert paged_attn.paged_prefill_attention.launches > 0
