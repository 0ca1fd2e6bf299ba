"""``launch.adam_probe.first_step`` on the CPU, at a reduced width.

The study of AdamW's first step runs on the card at full width; here, on
``reduced`` configs cut to one layer, sequence 64: its losses before the step
are the model's own on ``TokenStream``'s batches, the step is
``lm_steps.train_step``'s, each part's reading sets the other parts back to
their draw, and the gradient steps start from the draw. float32, so every
value is compared exactly or within 1e-6 relative.
"""

import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenStream
from repro_torch.launch import adam_probe
from repro_torch.models.lm import steps as lm_steps
from repro_torch.models.lm.config import reduced
from test_torch_threads import pin_torch_threads

pin_torch_threads()  # this worker's share of the cores under a parallel run

CPU = torch.device("cpu")
SEQ = 64


def _config(arch):
    return dataclasses.replace(reduced(get_config(arch)), num_layers=1)


def _draw(cfg):
    gen = torch.Generator(device=CPU).manual_seed(0)
    model, opt = lm_steps.init_train_state(gen, cfg, device=CPU)
    stream = TokenStream(cfg.vocab_size, 1, SEQ, seed=0, device=CPU)
    return model, opt, stream.batch(0), stream.batch(1)


def _loss(model, cfg, batch):
    with torch.no_grad():
        return float(lm_steps.loss_fn(model, cfg, batch)[0])


@pytest.mark.parametrize("arch", adam_probe.ARCHS)
def test_first_step_is_train_steps_step(arch):
    cfg = _config(arch)
    got = adam_probe.first_step(cfg, 3e-4, device=CPU, seq=SEQ)
    model, opt, b0, b1 = _draw(cfg)
    assert got["before"] == [_loss(model, cfg, b) for b in (b0, b1)]
    lm_steps.train_step(model, opt, b0, cfg, lr=3e-4)
    assert got["after"] == [_loss(model, cfg, b) for b in (b0, b1)]


@pytest.mark.parametrize("arch", adam_probe.ARCHS)
def test_first_step_parts_and_gradient_steps(arch):
    cfg = _config(arch)
    got = adam_probe.first_step(cfg, 3e-4, device=CPU, seq=SEQ, parts=True)
    model, opt, b0, b1 = _draw(cfg)
    names = [n for n, _ in model.named_parameters()]
    assert set(got["parts"]) == {adam_probe._part(n) for n in names}
    drawn = {n: p.detach().clone() for n, p in model.named_parameters()}
    lm_steps.train_step(model, opt, b0, cfg, lr=3e-4)
    stepped = {n: p.detach().clone() for n, p in model.named_parameters()}
    part = "blocks.0.mlp"
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(stepped[n] if n.startswith(part + ".") else drawn[n])
    assert got["parts"][part] == _loss(model, cfg, b1)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(drawn[n])
    total = lm_steps.loss_fn(model, cfg, b0)[0]
    grads = torch.autograd.grad(total, [p for _, p in model.named_parameters()])
    norm = float(torch.sqrt(sum((g ** 2).sum() for g in grads)))
    assert got["gradient"]["norm"] == pytest.approx(norm, rel=1e-6)
    with torch.no_grad():
        for (n, p), g in zip(model.named_parameters(), grads):
            p.copy_(drawn[n] - (0.1 / norm) * g)
    assert got["gradient"][0.1] == pytest.approx(_loss(model, cfg, b0), rel=1e-6)
