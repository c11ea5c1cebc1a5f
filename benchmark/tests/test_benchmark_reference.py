"""The frozen reference held to the port on the CPU at tiny widths: the point query, the
training render, the losses, a few train steps, a view and a manipulated view. The port's
CPU path is its fp32 plain version, so the two agree to float32 rounding."""

from __future__ import annotations

import pytest
import torch

from benchmark.drivers import program_config
from benchmark.reference import losses as ref_losses
from benchmark.reference import nerf
from benchmark.tests.tiny import tiny_cell
from benchmark.weights import make_models

# float32 through a 10-octave embedding: a z that differs in its last bit moves the
# top octave by 2^9 ulps of the point
TOL = dict(rtol=1e-4, atol=2e-5)


@pytest.fixture
def dmsr():
    c = tiny_cell("dmsr-study.train", width=32, rays=48)
    conf = c["conf"]
    pc, pf = make_models(conf, 3, torch.device("cpu"))
    g = torch.Generator().manual_seed(4)
    n = conf["N_train"]
    d = torch.randn(n, 3, generator=g)
    o = torch.randn(n, 3, generator=g) * 0.1 + torch.tensor([0.0, 0.0, 9.0])
    d[:, 2] = -d[:, 2].abs() - 1.0
    u_z = torch.rand(n, conf["N_samples"], generator=g)
    u_pdf = torch.rand(n, conf["N_importance"], generator=g)
    return c, conf, pc, pf, o, d, u_z, u_pdf, g


def test_query_is_the_ports(dmsr):
    from dmnerf_tpu_torch.core.pipeline import make_torch_query_fn

    c, conf, pc, pf, o, d, *_ = dmsr
    pts = nerf.points(o, d, nerf.z_lin(o.shape[0], conf, o.device))
    q = make_torch_query_fn(conf["multires"], conf["multires_views"], conf["netdepth"],
                            tuple(conf["skips"]))
    torch.testing.assert_close(nerf.query(pf, pts, nerf.unit(d), conf), q(pf, pts, nerf.unit(d)),
                               **TOL)


def test_training_render_and_losses_are_the_ports(dmsr):
    from dmnerf_tpu_torch.core.pipeline import make_query_fn, render_rays
    from dmnerf_tpu_torch.render.trainstep import Batch, compute_losses

    c, conf, pc, pf, o, d, u_z, u_pdf, g = dmsr
    cfg = program_config(conf, c["mix"])
    z = nerf.z_lin(o.shape[0], conf, o.device)
    info = render_rays(pc, pf, o, d, z, make_query_fn(cfg), conf["N_importance"], True,
                       u_z=u_z, u_pdf=u_pdf)
    out = nerf.render_batch(pc, pf, o, d, conf, u_z, u_pdf)
    # raw_fine is left out: at He's gain a z that differs in its last bits moves a raw
    # output of the top octave by up to 1e-2 (the query itself is held above)
    for mine, port in (("rgb_fine", "rgb_fine"), ("ins_coarse", "ins_coarse"),
                       ("z_fine", "z_vals_fine"), ("raw_coarse", "raw_coarse")):
        torch.testing.assert_close(out[mine], info[port], **TOL)
    labels = torch.randint(0, 5, (o.shape[0],), generator=g)
    rgb = torch.rand(o.shape[0], 3, generator=g)
    out["rays_d"] = d
    total, _ = compute_losses(cfg, info, Batch(o, d, rgb, labels), None)
    torch.testing.assert_close(ref_losses.step_loss(out, rgb, labels, conf), total, **TOL)


def test_instance_loss_on_a_labelled_suffix_is_the_ports():
    from dmnerf_tpu_torch.objfield.losses import ins_criterion

    g = torch.Generator().manual_seed(0)
    pred = torch.rand(2, 40, 6, generator=g)
    labels = torch.randint(0, 6, (40,), generator=g)
    mask = torch.rand(40, generator=g) > 0.2
    port = ins_criterion(pred, labels, 6, mask)[0]
    mine = torch.stack([ref_losses.ins_loss(p, labels, 6, mask) for p in pred])
    torch.testing.assert_close(mine, port, **TOL)


def test_a_view_is_the_ports(dmsr):
    from dmnerf_tpu_torch.render.renderer import make_image_renderer

    c, conf, pc, pf, o, d, *_ = dmsr
    cfg = program_config(conf, c["mix"], perturb=0.0)
    port = make_image_renderer(cfg)(pc, pf, o, d)
    rgb, ins = nerf.render_view(pc, pf, o, d, conf, chunk=conf["N_test"])
    torch.testing.assert_close(rgb, port["rgb"], **TOL)
    torch.testing.assert_close(ins, port["ins"], **TOL)


def test_a_manipulated_block_is_the_ports(dmsr):
    from dmnerf_tpu_torch.render.manipulator import manipulate_rays

    c, conf, pc, pf, o, d, _, _, g = dmsr
    cfg = program_config(conf, c["mix"], perturb=0.0)
    to = o + torch.tensor([0.0, -0.5, 0.0])
    u = [torch.rand(o.shape[0], conf["N_importance"], generator=g) for _ in range(4)]
    port = manipulate_rays(cfg, pc, pf, (o, d), [(to, d)], [2], u=u)
    rgb, ins = nerf.manipulate(pc, pf, (o, d), [(to, d)], [2], conf, [u[0], u[1], u[2]])
    torch.testing.assert_close(rgb, port["rgb"], **TOL)
    torch.testing.assert_close(ins, port["ins"], **TOL)


@pytest.mark.parametrize("prec", ["bf16", "fp8"])
def test_rounded_products_stay_near_float32(prec):
    g = torch.Generator().manual_seed(1)
    x, w = torch.randn(64, 32, generator=g), torch.randn(32, 16, generator=g)
    err = (nerf.mm(x, w, prec) - x @ w).abs().max() / (x @ w).abs().max()
    assert 0 < err < (0.02 if prec == "bf16" else 0.2)
