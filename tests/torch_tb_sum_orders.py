"""The TB rate's float sums against hmtpu's (ROADMAP.md queue C): hmtpu
sums each part of `tb_bits` in float32 in XLA's order, the port in
float64, rounded once.  For the 48 32x32 TBs of
`test_torch_inter_ops.py::test_tb_bits_and_rdoq_above_512_bits` (all
above 512 bits) this prints, for the exact sum and for each float32
order below, how many TBs get hmtpu's bits.

    JAX_PLATFORMS=cpu python -m tests.torch_tb_sum_orders    # repo root
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from hmtpu.common.constants import SliceType  # noqa: E402
from hmtpu.entropy.contexts import make_contexts  # noqa: E402
from hmtpu.entropy.fracbits import ctx_bits_table  # noqa: E402


def _sum_orders():
    """float32 sums over `dim` in several orders (plain torch)."""
    def flat(x, dim):
        dims = (dim,) if isinstance(dim, int) else tuple(dim)
        dims = sorted(d % x.dim() for d in dims)
        keep = [d for d in range(x.dim()) if d not in dims]
        return x.permute(keep + dims).reshape(
            [x.shape[d] for d in keep] + [-1]).to(torch.float32)

    def index(x, dim):
        y = flat(x, dim)
        acc = torch.zeros(y.shape[:-1], dtype=torch.float32)
        for i in range(y.shape[-1]):
            acc = acc + y[..., i]
        return acc

    def lanes(k, tree):
        def f(x, dim):
            y = flat(x, dim)
            n = y.shape[-1] - y.shape[-1] % k
            acc = torch.zeros(y.shape[:-1] + (k,), dtype=torch.float32)
            for i in range(0, n, k):
                acc = acc + y[..., i:i + k]
            if tree:
                while acc.shape[-1] > 1:
                    h = acc.shape[-1] // 2
                    acc = acc[..., :h] + acc[..., h:]
                tot = acc[..., 0]
            else:
                tot = torch.zeros(y.shape[:-1], dtype=torch.float32)
                for j in range(k):
                    tot = tot + acc[..., j]
            for i in range(n, y.shape[-1]):
                tot = tot + y[..., i]
            return tot
        return f

    orders = {"index order": index,
              "torch float32 sum": lambda x, d: x.to(torch.float32).sum(d),
              "numpy pairwise": lambda x, d: torch.as_tensor(np.sum(
                  x.to(torch.float32).numpy(), axis=d, dtype=np.float32))}
    for k in (2, 4, 8, 16, 32):
        orders[f"{k} accumulators, then in order"] = lanes(k, False)
    for k in (4, 8, 16, 32):
        orders[f"{k} accumulators, then a tree"] = lanes(k, True)
    return orders


def main():
    from hmtpu.ops import ratebits as jr
    from hmtpu_torch.ops import ratebits as pr

    jax.config.update("jax_platforms", "cpu")
    c = ctx_bits_table(make_contexts(SliceType.P, 22)).reshape(-1)
    jc, pc = jnp.asarray(c), torch.as_tensor(c)
    log2, n = 5, 32
    rng = np.random.RandomState(log2)
    yy, xx = np.mgrid[0:n, 0:n]
    lev = np.round(rng.randn(48, n, n) * 60 / (1 + 0.3 * (xx + yy))) \
        .astype(np.int32)
    want = np.asarray(jr.tb_bits(jnp.asarray(lev), jc, log2, True, 0, True))
    lev_t = torch.as_tensor(lev)
    got = pr.tb_bits(lev_t, pc, log2, True, 0, True).numpy()
    print(f"TBs above 512 bits: {int((want > 512).sum())} of 48")
    print(f"float64, rounded once: {int((got == want).sum())} of 48 "
          f"equal to hmtpu")
    exact_fsum = pr.fsum
    try:
        for name, f in _sum_orders().items():
            pr.fsum = f
            got = pr.tb_bits(lev_t, pc, log2, True, 0, True).numpy()
            print(f"{name}: {int((got == want).sum())} of 48 equal to hmtpu")
    finally:
        pr.fsum = exact_fsum


if __name__ == "__main__":
    main()
