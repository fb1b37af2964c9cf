"""A reference behaviour of ROADMAP.md queue C, held on the CPU.

The trainer's card and CPU runs parted where torch's CPU and CUDA
functions round differently: exp and log (K14) and sqrt (K16's Adam;
torch's CPU sqrt is not correctly rounded).  K14's exp and log are now
the port's own (`models/train.py` exp_f32 / log_f32, the same operations
as `csrc/nnfme_train.cuh` hm_expf / hm_logf): within one float32 ulp of
the exact values over the ranges the loss meets, and exact at the points
that matter (e^0 = 1, log 1 = 0).  The plain Adam's sqrt (`_sqrt`) is
correctly rounded, as K16's `__fsqrt_rn`.
"""
import numpy as np
import pytest
import torch

from tests.hmtpu_xla import release_programs  # noqa: F401 (autouse)


def _ulps(got, ref):
    """|got - ref| in float32 spacings of ref (float64 reference)."""
    sp = np.spacing(np.abs(ref).astype(np.float32)).astype(np.float64)
    return np.abs(got.astype(np.float64) - ref) / sp


@pytest.mark.parametrize("fn", ["exp", "log"])
def test_trainer_exp_log_within_one_ulp(fn):
    from hmtpu_torch.models import train

    if fn == "exp":
        # logit - max: the softmax's range, and a little past the cut
        x = torch.cat([torch.linspace(-87.0, 0.0, 400001),
                       -torch.rand(10000) * 1e-4]).to(torch.float32)
        got = train.exp_f32(x).numpy()
        ref = np.exp(x.double().numpy())
        assert float(train.exp_f32(torch.zeros(1))[0]) == 1.0
        assert (train.exp_f32(torch.tensor([-87.5, -200.0])) == 0).all()
    else:
        # the 49-term sums of the softmax lie in [1, 49]; wider as well
        x = torch.cat([torch.linspace(1.0, 49.0, 400001),
                       torch.exp(torch.linspace(-80.0, 80.0, 10001))]) \
            .to(torch.float32)
        x = x[x > 0]
        got = train.log_f32(x).numpy()
        ref = np.log(x.double().numpy())
        assert float(train.log_f32(torch.ones(1))[0]) == 0.0
        keep = np.abs(ref) > 1e-30
        got, ref = got[keep], ref[keep]
    assert got.dtype == np.float32
    assert _ulps(got, ref).max() <= 1.0


def test_adam_sqrt_correctly_rounded():
    from hmtpu_torch.models import train

    rng = np.random.RandomState(0)
    x = np.concatenate([rng.rand(1 << 20) * 10.0 ** e for e in
                        (-40, -30, -8, -5, 0, 30)]).astype(np.float32)
    x = np.concatenate([x, np.float32([0.0, 1e-45, 2.0, 3.4e38])])
    got = train._sqrt(torch.as_tensor(x)).numpy()
    assert got.dtype == np.float32
    # numpy's float32 sqrt is the IEEE (correctly rounded) one
    np.testing.assert_array_equal(got.view(np.int32),
                                  np.sqrt(x).view(np.int32))
