"""The frozen plain references held to the port's plain path at a tiny
preset on the CPU (the test imports the port; the references do not),
and the weights' layout held to the port's own initialiser."""
import copy

import pytest
import torch

from benchlib import spec


def tiny_zamba2(dtype="float32"):
    cell = spec.load_cell("zamba2.prefill.mesh")
    cfg = copy.deepcopy(cell.config)
    cfg["model"].update(n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
                        d_ff=128, vocab=500, ssm_state=16, ssm_head_dim=16,
                        ssm_chunk=16, shared_attn_period=2, dtype=dtype)
    return cell, cfg


def port_config(cfg):
    from repro_torch.models.model import ModelConfig

    return ModelConfig(**dict(cfg["model"],
                              dtype=getattr(torch, cfg["model"]["dtype"])))


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,))
    else:
        yield path, (tuple(tree.shape), tree.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zamba2_layout_is_the_ports(dtype):
    from repro_torch.models.model import init_params

    cell, cfg = tiny_zamba2(dtype)
    mine = cell.reference.make_params(cfg, torch.Generator().manual_seed(3),
                                      "cpu")
    port = init_params(port_config(cfg), torch.Generator().manual_seed(0),
                       device="cpu")
    assert dict(leaves(mine)) == dict(leaves(port))


def test_zamba2_layout_at_full_size_on_meta():
    from repro_torch.models.model import init_params

    cell = spec.load_cell("zamba2.prefill.mesh")
    shapes = {p: (tuple(s[1]), getattr(torch, s[3]))
              for p, s in cell.reference._leaves(
                  cell.reference.layout(cell.config["model"]))}
    port = init_params(port_config(cell.config),
                       torch.Generator().manual_seed(0), device="meta")
    assert shapes == dict(leaves(port))
    n = sum(torch.Size(s).numel() for s, _ in shapes.values())
    assert 1.0e9 < n < 1.3e9


@pytest.mark.parametrize("T", [37, 100])
def test_zamba2_reference_is_the_ports_plain_forward(T):
    from repro_torch.models.model import forward

    cell, cfg = tiny_zamba2()
    params = cell.reference.make_params(cfg, torch.Generator().manual_seed(5),
                                        "cpu")
    toks = torch.randint(0, 500, (2, T), generator=torch.Generator()
                         .manual_seed(6))
    want = forward(port_config(cfg), params, tokens=toks)[..., :500]
    got = cell.reference.forward(cfg, params, toks)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    last = cell.reference.forward(cfg, params, toks, last=3)
    assert torch.allclose(last, got[:, -3:], rtol=0, atol=1e-5)


def test_zamba2_control_reads_float8_weights():
    cell, cfg = tiny_zamba2()
    ref = cell.reference
    w = torch.randn(64, 64, generator=torch.Generator().manual_seed(1))
    q = ref.fp8(w)
    assert not torch.equal(q, w)
    assert ((q - w).abs().max() / w.abs().max()) < 2 ** -4
    params = ref.make_params(cfg, torch.Generator().manual_seed(5), "cpu")
    toks = torch.randint(0, 500, (1, 40))
    a = ref.forward(cfg, params, toks)
    b = ref.forward(cfg, params, toks, quant=True)
    assert 0 < float((a - b).abs().max()) < 0.5 * float(a.abs().max())


def test_vgg16_reference_is_the_ports_uncoded_forward():
    from repro_torch.models.cnn import vgg16_forward

    cell = spec.load_cell("vgg16.b128.pool")
    cfg = copy.deepcopy(cell.config)
    cfg.update(image=32, classes=10)
    for row in cfg["conv_layers"]:
        row[3] = row[3] * 32 // 224
    ref = cell.reference
    params = ref.make_params(cfg, torch.Generator().manual_seed(1), "cpu")
    x = ref.make_inputs(cfg, torch.Generator().manual_seed(2), 2, "cpu")
    want = vgg16_forward(params, x)
    got = ref.forward(cfg, params, x)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    ctl = ref.forward(cfg, params, x, tf32=True)
    assert float((ctl - got).abs().max()) > 1e-5 * float(got.abs().max())


def test_vgg16_layers_are_the_ports():
    from repro_torch.models.cnn import vgg16_conv_specs

    cell = spec.load_cell("vgg16.b128.pool")
    cfg, ref = cell.config, cell.reference
    specs = vgg16_conv_specs(cfg["image"])
    assert len(specs) == len(cfg["conv_layers"])
    for li, (name, ci, co, size, pool) in zip(specs, cfg["conv_layers"]):
        assert (li.name, li.spec.c_in, li.spec.c_out, li.spec.w_out,
                li.pool) == (name, ci, co, size, pool)
    params = ref.make_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert ref.head_features(cfg) == 25088
    assert sum(w.numel() for w in params["convs"]) == 14710464
    assert tuple(params["head"].shape) == (25088, 1000)


def test_round_tf32_keeps_ten_mantissa_bits():
    ref = spec.load_cell("vgg16.b128.pool").reference
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11 + 2 ** -12, 3.0])
    y = ref.round_tf32(x)
    assert y.tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 3.0]
