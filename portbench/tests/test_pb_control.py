"""The control's precision by the configuration's dtype: TF32 under f32;
under bf16 every convolution on fp8 operands (e4m3, scaled per tensor),
its output gradient too, with gradients straight through to any order."""
import torch
import torch.nn.functional as F

from harness.common import E4M3_MAX, control_precision, fp8_round


def test_fp8_round_keeps_three_mantissa_bits_and_passes_gradients():
    g = torch.Generator().manual_seed(5)
    x = (torch.randn(4096, generator=g) * 3e-3).requires_grad_(True)
    q = fp8_round(x)
    scale = float(x.detach().abs().max()) / E4M3_MAX
    # every value is an e4m3 number times the tensor's scale
    assert torch.equal((q.detach() / scale).to(torch.float8_e4m3fn).float()
                       * scale, q.detach())
    normal = x.detach().abs() >= 2 ** -6 * scale      # e4m3's normal range
    rel = ((q - x).abs() / x.abs()).detach()[normal]
    assert 0 < float(rel.max()) <= 2 ** -4
    (gx,) = torch.autograd.grad(q.square().sum(), x, create_graph=True)
    assert torch.allclose(gx, 2 * q)
    (ggx,) = torch.autograd.grad(gx.sum(), x)
    assert torch.allclose(ggx, torch.full_like(ggx, 2.0))


def test_bf16_control_computes_convolutions_in_fp8():
    g = torch.Generator().manual_seed(6)
    x = torch.randn(2, 4, 5, 6, 7, generator=g, requires_grad=True)
    w = (torch.randn(8, 4, 3, 3, 3, generator=g) * 0.05).requires_grad_(True)
    dy = torch.randn(2, 8, 5, 6, 7, generator=g)
    with control_precision(True):
        y = F.conv3d(x, w, None, 1, 1)
        gx, gw = torch.autograd.grad(y, (x, w), dy)
    xq, wq, dyq = (fp8_round(t.detach()) for t in (x, w, dy))
    assert torch.allclose(y, F.conv3d(xq, wq, None, 1, 1), atol=1e-6)
    want = torch.nn.grad.conv3d_input(x.shape, wq, dyq, padding=1)
    assert torch.allclose(gx, want, atol=1e-5)
    want = torch.nn.grad.conv3d_weight(xq, w.shape, dyq, padding=1)
    assert torch.allclose(gw, want, atol=1e-4)
    plain = F.conv3d(x, w, None, 1, 1)          # outside: untouched
    assert not torch.allclose(plain, y, atol=1e-4)
    assert torch.allclose(plain, F.conv3d(x.detach(), w.detach(), None, 1,
                                          1))


def test_f32_control_is_tf32():
    saved = torch.backends.cudnn.allow_tf32
    with control_precision(False):
        assert torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32 == saved
