"""The generalised ``spmd.Optimizer`` over any parameter tree, on the CPU.

``Optimizer.init`` takes any nest of dicts and lists: the subtrees the
model names as stacked get per-layer leaf views, every other floating
tensor is a leaf of its own. One update must equal the global-norm clip
followed by ``torch.optim.AdamW`` applied leaf by leaf (f32, 1e-6: the
same elementwise arithmetic); ViT and UNet trees train, every leaf getting
a gradient and moving. The Llama step's own tests stay in
``tests/test_torch_train.py``.
"""

import math

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import _tree, diffusion, vit
from ray_tpu_torch.models.quant import QuantTensor
from ray_tpu_torch.parallel import spmd


def _tree_of_shapes(seed):
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=g)

    return {"embed": r(6, 4),
            "stack": {"w": r(3, 4, 5), "ln": r(3, 4)},
            "levels": [{"conv": r(3, 3, 2, 2)}, {"conv": r(3, 3, 2, 4),
                                                 "b": r(4)}],
            "steps": torch.arange(5)}     # not floating: not trained


def _loss(params, opt):
    """A loss that reaches every floating leaf, through the leaf views
    for the stacked subtree."""
    x = params["embed"].sum(0)                                   # [4]
    for layer in opt.layers["stack"]:
        x = torch.tanh(x * (1 + layer["ln"]) @ layer["w"])[:4]
    out = x.square().sum()
    for level in params["levels"]:
        out = out + sum(v.sin().sum() for v in level.values())
    return out


def test_init_marks_every_floating_leaf_and_views_the_stack():
    params = _tree_of_shapes(0)
    tx = spmd.default_optimizer()
    opt = tx.init(params, stacked=("stack",))
    assert len(opt.layers["stack"]) == 3
    view = opt.layers["stack"][1]["w"]
    assert view.untyped_storage().data_ptr() == \
        params["stack"]["w"].untyped_storage().data_ptr()
    assert view.requires_grad and view.is_leaf
    n_top = 1 + 3                     # embed, levels' conv, conv, b
    assert len(opt.leaves) == n_top + 3 * 2
    assert not params["steps"].requires_grad
    assert not params["stack"]["w"].requires_grad   # its views are the leaves


@pytest.mark.parametrize("clip", [0.05, 1e3], ids=["clipped", "unclipped"])
def test_one_update_equals_clip_then_adamw_leaf_by_leaf(clip):
    params = _tree_of_shapes(1)
    tx = spmd.Optimizer(lr=1e-2, weight_decay=0.1, warmup=1, decay_steps=10,
                        grad_clip=clip)
    opt = tx.init(params, stacked=("stack",))
    before = {id(t): t.detach().clone() for t in _tree.leaves(params)
              if t.is_floating_point()}
    _loss(params, opt).backward()
    grads = {id(p): p.grad.clone() for p in opt.leaves}
    norm = math.sqrt(sum(float(g.double().square().sum())
                         for g in grads.values()))
    scale = 1.0 if norm < clip else clip / norm
    step = 3
    gnorm = tx.update(opt, step)
    np.testing.assert_allclose(gnorm.item(), norm, rtol=1e-6)

    # The reference: every leaf its own AdamW, one step from zero moments.
    for p in opt.leaves:
        ref = before[id(p)] if id(p) in before else None
        if ref is None:     # a layer view: its slice of the stacked tensor
            continue
        q = ref.clone().requires_grad_()
        q.grad = grads[id(p)] * scale
        ref_opt = torch.optim.AdamW([q], lr=tx.schedule(step),
                                    betas=(tx.b1, tx.b2), eps=tx.eps,
                                    weight_decay=tx.weight_decay)
        ref_opt.step()
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   rtol=1e-6, atol=1e-7)
    stack_before = before[id(params["stack"]["w"])]
    for i, layer in enumerate(opt.layers["stack"]):
        q = stack_before[i].clone().requires_grad_()
        q.grad = grads[id(layer["w"])] * scale
        torch.optim.AdamW([q], lr=tx.schedule(step), betas=(tx.b1, tx.b2),
                          eps=tx.eps, weight_decay=tx.weight_decay).step()
        np.testing.assert_allclose(params["stack"]["w"][i].detach().numpy(),
                                   q.detach().numpy(), rtol=1e-6, atol=1e-7)
    assert all(p.grad is None for p in opt.leaves)


def test_init_refuses_what_it_cannot_train():
    tx = spmd.default_optimizer()
    with pytest.raises(ValueError, match="not in the parameters"):
        tx.init(_tree_of_shapes(0), stacked=("blocks",))
    bad = _tree_of_shapes(0)
    bad["stack"]["ln"] = torch.zeros(2, 4)
    with pytest.raises(ValueError, match="number of layers"):
        tx.init(bad, stacked=("stack",))
    quant = _tree_of_shapes(0)
    quant["embed"] = QuantTensor(torch.zeros(6, 4, dtype=torch.int8),
                                 torch.ones(4))
    with pytest.raises(ValueError, match="int8"):
        tx.init(quant, stacked=("stack",))


def _train_and_check(params, stacked, loss_of, steps=3):
    """A few steps; every trainable leaf gets a gradient every step and
    ends away from where it started."""
    tx = spmd.default_optimizer(lr=1e-2, warmup=1, decay_steps=10)
    opt = tx.init(params, stacked=stacked)
    start = [p.detach().clone() for p in opt.leaves]
    for step in range(steps):
        loss = loss_of(opt)
        loss.backward()
        missing = [i for i, p in enumerate(opt.leaves) if p.grad is None]
        assert not missing, missing
        tx.update(opt, step)
    moved = [bool((p.detach() != s).any()) for p, s in zip(opt.leaves, start)]
    assert all(moved), moved.index(False)
    return opt


def test_vit_tree_trains_every_leaf():
    cfg = vit.tiny_config()
    params = vit.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(4, 32, 32, 3).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 10, 4))
    opt = _train_and_check(params, vit.STACKED, lambda opt: vit.loss_fn(
        params, x, y, cfg, layers=opt.layers["blocks"]))
    assert len(opt.leaves) == 5 + cfg.n_layers * 8


def test_unet_tree_of_nested_lists_trains_every_leaf():
    cfg = diffusion.tiny_config()
    params = diffusion.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
    gen = torch.Generator().manual_seed(1)
    x0 = torch.randn(4, 8, 8, 1, generator=gen)
    t = torch.randint(0, cfg.num_steps, (4,), generator=gen)
    eps = torch.randn(x0.shape, generator=gen)
    opt = _train_and_check(params, diffusion.STACKED, lambda opt:
                           diffusion.loss_fn(params, x0, None, cfg, t=t,
                                             eps=eps)[0])
    assert len(opt.leaves) == len(_tree.leaves(params))
    assert isinstance(params["downs"], list) and isinstance(params["ups"],
                                                            list)
