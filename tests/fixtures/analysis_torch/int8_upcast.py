"""Seeded-bad trace: pool-scale int8 dequantization before the product.

Converting the whole int8 pool to float32 outside a kernel entry throws
away the integer dot (and moves four times the bytes).  The op audit
must flag ``int8-upcast``.
"""

import torch

FIXTURE_KIND = "trace"
EXPECT_RULES = ("int8-upcast",)


def build():
    def score(queries, pool_codes):
        # 1M int8 codes dequantized at once (the legitimate ceiling is the
        # [Q, K', D] re-rank gather, about 0.5M elements at the audit size)
        deq = pool_codes.to(torch.float32)
        return torch.topk(queries @ deq.T, 10)

    g = torch.Generator().manual_seed(0)
    return {
        "name": "fixture/int8_upcast",
        "fn": score,
        "args": (torch.randn(64, 64, generator=g),
                 torch.randint(-127, 128, (16384, 64), dtype=torch.int8,
                               generator=g)),
        # generous: only the int8 rule should fire
        "budget_bytes": 64 << 20,
        "int8_contract": True,
    }
