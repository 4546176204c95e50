"""Time the port's token attention kernel (TPU kernel #13) on the card.

    python3 scripts/time_token_attention.py [LABEL]

Runs ``freqfusion_tpu_torch.ops.token_attention.token_attention`` at the
fusion net's two geometries over the 336x512 bucket's 172,032 pixels (T 9,
E 64, 4 heads; T 4, E 128, 8 heads), the weights handed as the gated
module hands them (transposed views), and prints one line: the label, each
geometry's kernel time in ms (CUDA events around one call, median of 20
after 3 warm-up calls) and their sum. It checks nothing: run from a copy of
the tree with an edited kernel (a part left out, say), it times that copy,
which is how the parts of the kernel can be weighed against each other.
``chip_smoke.py --token-only`` checks the kernel against its plain version
and times it beside its bound.
"""

import statistics
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from freqfusion_tpu_torch.ops import cuda  # noqa: E402
from freqfusion_tpu_torch.ops.token_attention import (  # noqa: E402
    token_attention)

GEOMETRIES = ((9, 64, 4), (4, 128, 8))
PIXELS = 336 * 512


def main(label: str) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("time_token_attention: no CUDA device")
    cuda.library()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    times = []
    for t, e, nh in GEOMETRIES:
        x = torch.randn(PIXELS, t, e, device=dev, generator=g)
        win = torch.randn(3 * e, e, device=dev, generator=g) * e ** -0.5
        wout = torch.randn(e, e, device=dev, generator=g) * e ** -0.5
        b_in = torch.randn(3 * e, device=dev, generator=g) * 0.1
        b_out = torch.randn(e, device=dev, generator=g) * 0.1
        args = (x, win.t(), b_in, wout.t(), b_out, nh)
        for _ in range(3):
            token_attention(*args)
        runs = []
        for _ in range(20):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            token_attention(*args)
            end.record()
            end.synchronize()
            runs.append(start.elapsed_time(end))
        times.append(statistics.median(runs))
    print(label, " ".join(f"{ms:.3f}" for ms in times),
          f"sum {sum(times):.3f}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "token_attention")
