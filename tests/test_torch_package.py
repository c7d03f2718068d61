"""Package boundaries of the port: ``ray_tpu_torch`` and ``chip_smoke.py``
use neither JAX nor ``ray_tpu``, and their entry points run on the card
unless the caller asks for the CPU."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "ray_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_neither_jax_nor_ray_tpu(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "ray_tpu", "flax", "optax"), (
            f"{path.relative_to(ROOT)} imports {mod}")


def test_importing_and_serving_loads_no_jax_module():
    """In a fresh interpreter: import the package, build a CPU engine and
    serve a request, then one with every engine knob on (paged decode,
    speculation, chunked prefill, int8), then take two training steps with
    remat and the fused ops, then a step of each other model (Mixtral,
    ViT, T5, the UNet, and a UNet sample), then build RLlib's PPO and
    take one ``train()`` step, then serve the engine through
    ``build_llm_deployment`` on the local runtime (a reply and a stream);
    no jax* and no ray_tpu / ray_tpu.* module may load."""
    code = (
        "import sys, torch\n"
        "import ray_tpu_torch, ray_tpu_torch.ops\n"
        "from ray_tpu_torch.models import llama\n"
        "from ray_tpu_torch.serve.llm import LLMEngine\n"
        "cfg = llama.tiny_config(max_seq_len=64, fused_ops=True)\n"
        "p = llama.init_params(cfg, torch.Generator().manual_seed(0), 'cpu')\n"
        "e = LLMEngine(cfg, p, max_batch=2, max_len=64,\n"
        "              prompt_buckets=[8, 16], device='cpu')\n"
        "out = e.generate([1, 2, 3], max_new_tokens=5)\n"
        "e.close()\n"
        "assert out['num_generated'] == 5, out\n"
        "e = LLMEngine(cfg, p, max_batch=2, max_len=64,\n"
        "              prompt_buckets=[8, 16], device='cpu',\n"
        "              paged_decode=True, spec_draft_len=2, spec_chunk=2,\n"
        "              prefill_chunk=8, quantize='int8')\n"
        "out = e.generate([7] * 20, max_new_tokens=12)\n"
        "stats = e.stats()\n"
        "e.close()\n"
        "assert out['num_generated'] == 12, out\n"
        "assert stats['spec_chunks'] > 0, stats\n"
        "from ray_tpu_torch.parallel import spmd\n"
        "tcfg = llama.tiny_config(fused_ops=True, remat=True)\n"
        "tx = spmd.default_optimizer(lr=1e-2, warmup=1)\n"
        "st = spmd.init_train_state(tcfg, torch.Generator().manual_seed(0),\n"
        "                           tx, device='cpu')\n"
        "step = spmd.make_train_step(tcfg, tx)\n"
        "tok = torch.randint(0, 256, (2, 16))\n"
        "for _ in range(2):\n"
        "    st, m = step(st, tok)\n"
        "assert st.step == 2 and torch.isfinite(m['grad_norm']), m\n"
        "from ray_tpu_torch.models import diffusion, mixtral, t5, vit\n"
        "g = torch.Generator().manual_seed(0)\n"
        "def train(mod, cfg, loss, stacked):\n"
        "    p = mod.init_params(cfg, g, 'cpu')\n"
        "    opt = tx.init(p, stacked=stacked)\n"
        "    out = loss(p, opt.layers)\n"
        "    out = out[0] if isinstance(out, tuple) else out\n"
        "    out.backward()\n"
        "    assert torch.isfinite(tx.update(opt, 1))\n"
        "train(mixtral, mixtral.tiny_moe_config(remat=True),\n"
        "      lambda p, l: mixtral.loss_fn(p, tok[:, :8] % 128,\n"
        "          mixtral.tiny_moe_config(remat=True), layers=l['blocks']),\n"
        "      mixtral.STACKED)\n"
        "train(vit, vit.tiny_config(), lambda p, l: vit.loss_fn(\n"
        "    p, torch.rand(2, 32, 32, 3), torch.tensor([1, 2]),\n"
        "    vit.tiny_config(), layers=l['blocks']), vit.STACKED)\n"
        "train(t5, t5.tiny_config(), lambda p, l: t5.loss_fn(\n"
        "    p, tok[:, :6], tok[:, 6:], t5.tiny_config(), layers=l),\n"
        "    t5.STACKED)\n"
        "dcfg = diffusion.tiny_config()\n"
        "train(diffusion, dcfg, lambda p, l: diffusion.loss_fn(\n"
        "    p, torch.randn(2, 8, 8, 1), g, dcfg), diffusion.STACKED)\n"
        "dp = diffusion.init_params(dcfg, g, 'cpu')\n"
        "assert diffusion.sample(dp, g, dcfg, batch=1).shape == (1, 8, 8, 1)\n"
        "from ray_tpu_torch.rllib import PPOConfig\n"
        "algo = (PPOConfig(device='cpu').environment('CartPole')\n"
        "        .env_runners(num_envs_per_env_runner=4,\n"
        "                     rollout_fragment_length=16)\n"
        "        .training(minibatch_size=32).build())\n"
        "r = algo.train()\n"
        "assert r['num_env_steps_sampled_lifetime'] == 64, r\n"
        "from ray_tpu_torch import serve\n"
        "from ray_tpu_torch.serve.llm import build_llm_deployment\n"
        "ray_tpu_torch.init(local_mode=True)\n"
        "h = serve.run(build_llm_deployment(num_replicas=2, engine_kwargs=\n"
        "    dict(cfg=cfg, params=p, max_batch=2, max_len=64,\n"
        "         prompt_buckets=[8, 16], device='cpu')))\n"
        "req = {'prompt_ids': [1, 2, 3], 'max_new_tokens': 3}\n"
        "assert h.remote(req).result(timeout=60)['num_generated'] == 3\n"
        "assert len(list(h.options('stream', stream=True).remote(req))) == 3\n"
        "serve.shutdown()\n"
        "ray_tpu_torch.shutdown()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'ray_tpu'))\n"
        "print('BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout


def test_device_none_means_the_card():
    from ray_tpu_torch import resolve_device
    from ray_tpu_torch.models import llama

    cfg = llama.tiny_config()
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        llama.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError):
        llama.init_kv_cache(cfg, 1, 8)
    from ray_tpu_torch.serve.llm import LLMEngine

    with pytest.raises(RuntimeError):
        LLMEngine(cfg, max_batch=1, max_len=32, prompt_buckets=[8])
    from ray_tpu_torch.parallel import spmd

    with pytest.raises(RuntimeError):
        spmd.init_train_state(cfg, torch.Generator().manual_seed(0),
                              spmd.default_optimizer())
    from ray_tpu_torch.models import diffusion, mixtral, t5, vit

    for init, mcfg in ((mixtral.init_params, mixtral.tiny_moe_config()),
                       (vit.init_params, vit.tiny_config()),
                       (t5.init_params, t5.tiny_config()),
                       (diffusion.init_params, diffusion.tiny_config())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init(mcfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        diffusion.cosine_schedule(diffusion.tiny_config())
    from ray_tpu_torch import rllib
    from ray_tpu_torch.rllib import dqn, impala, multi_agent, sac

    for make in (lambda: rllib.PPOLearner(4, 2),
                 lambda: rllib.DQNLearner(4, 2),
                 lambda: rllib.SACLearner(3, 1),
                 lambda: impala.IMPALALearner(4, 2),
                 lambda: rllib.BCLearner(4, 2),
                 lambda: rllib.CQLLearner(4, 2),
                 lambda: rllib.EnvRunner("CartPole", 2, 4),
                 lambda: dqn._DQNRunner("CartPole", 2),
                 lambda: sac._SACRunner("Pendulum", 2),
                 lambda: rllib.PPOConfig().build(),
                 lambda: rllib.DQNConfig().build(),
                 lambda: rllib.SACConfig().build(),
                 lambda: impala.IMPALAConfig().build(),
                 lambda: multi_agent.MultiAgentPPOConfig(
                     env=lambda num_envs, seed: multi_agent.
                     IndependentEnsembleEnv({"a": "CartPole"}, num_envs,
                                            seed)).build(),
                 lambda: rllib.models.from_jax_params({"w0": [1.0]})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert resolve_device("cpu") == torch.device("cpu")


def _smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card_or_the_package(tmp_path):
    """Without a card the script exits non-zero and prints no result line;
    the same holds in a directory that holds the script alone."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs for real there")
    res = _smoke(ROOT)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
