"""The plain serving path of two checkouts of the port, compared on one
card: one checkout against another (say a parent commit's, unpacked with
``git archive``), each run in its own process, interleaved so that a
drift of the card or the host falls on both.

``--mode phases`` (order A, B, B, A) runs ``chip_smoke.py``'s serve phase
(``check_serve``: gemma2-2b at full width, traffic (A) twice and (B)) and
four of its families (``families_v2``, ``families_recurrent`` for
mamba2-780m and recurrentgemma-2b, ``families_encdec``) and prints each
decode ms a step (median, min and max) as the phase prints it.

``--mode host`` (order A, B, A, B, A, B) draws gemma2-2b and
recurrentgemma-2b at full width from ``prng.key(0)``, prefills 4 slots
of 256 with a 128-token prompt and runs 96 greedy ``decode_step`` calls.
The card is synchronised before each call, so its time on the host
(``perf_counter`` around the call, no back-pressure from the queue) is
the host's enqueue of one step; the time to the next token is its wall
time. Printed: the median, min and max of both over the last 80 steps.

``--mode ops`` (order A, B) needs no card: on the CPU, at the smoke
widths of gemma2-2b, recurrentgemma-2b, mamba2-780m and
deepseek-v2-236b and each one's full depth, it counts what one
``decode_step`` (2 slots of 64 after an 8-token prompt) costs the host:
the aten ops it dispatches and the Python calls it makes (``cProfile``).

The other two modes need a CUDA card. E.g.::

    git archive HEAD~1 | tar -x -C /tmp/parent
    python tests/torch_serve_ab.py /tmp/parent . --mode host
"""
import argparse
import os
import subprocess
import sys

PHASES = r'''
import gc, sys, time
import torch
sys.path.insert(0, ".")
import chip_smoke as C
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
dev = torch.device("cuda", 0)
card = C.card_line()
print(card, flush=True)
C.check_serve(dev, card)
gc.collect(); torch.cuda.empty_cache()
torch.zeros((), device=dev)
held = torch.cuda.memory_allocated(dev)
for f in (lambda: C.families_v2(dev, card, held),
          lambda: C.families_recurrent("mamba2-780m", dev, card, held),
          lambda: C.families_recurrent("recurrentgemma-2b", dev, card, held),
          lambda: C.families_encdec(dev, card, held)):
    f(); gc.collect(); torch.cuda.empty_cache()
'''

HOST = r'''
import statistics, sys, time
import torch
sys.path.insert(0, "src")
from repro_torch.config import get_config
from repro_torch.core import prng
from repro_torch.models.model import Model
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
for arch in ("gemma2-2b", "recurrentgemma-2b"):
    model = Model(get_config(arch), dev)
    model.init(prng.key(0))
    params = model.params()
    caches = model.init_caches(4, 256)
    g = torch.Generator().manual_seed(0)
    tok = torch.randint(0, 200, (4, 128), generator=g, dtype=torch.int32)
    host, wall = [], []
    with torch.no_grad():
        logits, caches, _ = model.prefill(params, {"tokens": tok.to(dev)},
                                          caches)
        nxt = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        for i in range(96):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = model.decode_step(params, {"tokens": nxt},
                                               caches, 128 + i)
            t1 = time.perf_counter()
            nxt = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
            torch.cuda.synchronize()
            host.append(1e3 * (t1 - t0))
            wall.append(1e3 * (time.perf_counter() - t0))
    h, w = host[16:], wall[16:]
    print(f"{arch}: decode_step host enqueue median {statistics.median(h):.3f} ms "
          f"(min {min(h):.3f}, max {max(h):.3f}); wall to the token median "
          f"{statistics.median(w):.3f} ms (min {min(w):.3f}, max {max(w):.3f}); "
          f"80 steps after 16", flush=True)
    del model, params, caches, logits
    torch.cuda.empty_cache()
'''

OPS = r'''
import collections, cProfile, dataclasses, pstats, sys
import torch
sys.path.insert(0, "src")
from torch.utils._python_dispatch import TorchDispatchMode
from repro_torch.config import get_config
from repro_torch.core import prng
from repro_torch.models.model import Model


class Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


for arch in ("gemma2-2b", "recurrentgemma-2b", "mamba2-780m",
             "deepseek-v2-236b"):
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              num_layers=get_config(arch).num_layers)
    model = Model(cfg, torch.device("cpu"))
    model.init(prng.key(0))
    params = model.params()
    caches = model.init_caches(2, 64)
    g = torch.Generator().manual_seed(0)
    tok = torch.randint(0, 200, (2, 8), generator=g, dtype=torch.int32)
    with torch.no_grad():
        logits, caches, _ = model.prefill(params, {"tokens": tok}, caches)
        nxt = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        with Count() as count:
            model.decode_step(params, {"tokens": nxt}, caches, 8)
        prof = cProfile.Profile()
        prof.enable()
        model.decode_step(params, {"tokens": nxt}, caches, 9)
        prof.disable()
    print(f"{arch} (smoke widths, {cfg.num_layers} layers): one decode_step "
          f"dispatches {sum(count.ops.values())} aten ops and makes "
          f"{pstats.Stats(prof).total_calls} Python calls", flush=True)
'''


def decode_lines(stdout: str):
    """The decode ms of each line of the serve and families phases."""
    for line in stdout.splitlines():
        if " decode " in line and "ms a step" in line:
            at = line.index("decode ")
            yield f"  {line.split(':')[0]}: {line[at:line.index(')', at) + 1]}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a", help="checkout A (its root)")
    ap.add_argument("b", help="checkout B (its root)")
    ap.add_argument("--mode", choices=("phases", "host", "ops"),
                    required=True)
    ap.add_argument("--log", default=None,
                    help="write each run's whole output here")
    args = ap.parse_args()
    a, b = os.path.abspath(args.a), os.path.abspath(args.b)
    order = {"phases": [("A", a), ("B", b), ("B", b), ("A", a)],
             "host": [("A", a), ("B", b)] * 3,
             "ops": [("A", a), ("B", b)]}[args.mode]
    body = {"phases": PHASES, "host": HOST, "ops": OPS}[args.mode]
    if args.mode != "ops":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    log = open(args.log, "w") if args.log else None
    rc = 0
    for i, (name, tree) in enumerate(order):
        p = subprocess.run([sys.executable, "-c", body], cwd=tree,
                           capture_output=True, text=True, timeout=400)
        print(f"===== run {i} {name} rc {p.returncode}", flush=True)
        if log:
            log.write(f"===== run {i} {name} rc {p.returncode}\n"
                      f"{p.stdout}\n{p.stderr}\n")
            log.flush()
        if args.mode == "phases":
            print("\n".join(decode_lines(p.stdout)), flush=True)
        else:
            print(p.stdout, flush=True)
        if p.returncode:
            print(p.stderr[-3000:], flush=True)
        rc = rc or p.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
