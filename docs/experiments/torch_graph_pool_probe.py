#!/usr/bin/env python3
"""What ``utils.graphs.graphed`` and the graphed train step rely on in
PyTorch's CUDA graphs, probed on one NVIDIA GPU:

1. a memory pool handle (``torch.cuda.graph_pool_handle``) taken again by
   a capture after every graph captured in it was freed (with and without
   ``empty_cache`` between), and after one of two graphs in it was freed;
2. ``torch.optim.AdamW(capturable=True)`` with a tensor lr on the card
   under ``LambdaLR``: whether ``scheduler.step()`` syncs with the host
   (``set_sync_debug_mode("error")``, then ``"warn"``), whether the lr
   tensor keeps its identity, and a replay after it;
3. ``torch.optim.SGD`` with a tensor lr: an eager step under
   ``set_sync_debug_mode("error")`` and a capture.

    python3 docs/experiments/torch_graph_pool_probe.py

Prints one line a check; ~20 s of command.
"""
import sys, warnings, subprocess
import torch
print(sys.version, torch.__version__, torch.version.cuda, flush=True)
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
dev = torch.device("cuda")

def capture(fn, x, pool):
    g = torch.cuda.CUDAGraph()
    s = torch.cuda.Stream(); s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn(x)
    torch.cuda.current_stream().wait_stream(s)
    with torch.cuda.graph(g, pool=pool):
        out = fn(x)
    return g, out

def f(x):
    y = x * 2
    z = y.sin() + 1
    return z.sum()

# 1. reuse a pool handle after every graph of it was freed
h = torch.cuda.graph_pool_handle()
x = torch.randn(1 << 20, device=dev)
g, out = capture(f, x, h)
g.replay(); torch.cuda.synchronize()
print("1a. capture in handle ok", h, flush=True)
del g, out
torch.cuda.synchronize()
try:
    g2, out2 = capture(f, x, h)
    g2.replay(); torch.cuda.synchronize()
    print("1b. reuse after all graphs freed: OK", flush=True)
    del g2, out2
except Exception as e:
    print("1b. reuse after all graphs freed: RAISES", type(e).__name__, str(e)[:300], flush=True)
# 1c. with empty_cache in between
h = torch.cuda.graph_pool_handle()
g, out = capture(f, x, h); del g, out; torch.cuda.empty_cache()
try:
    g2, out2 = capture(f, x, h); g2.replay(); torch.cuda.synchronize()
    print("1c. reuse after all freed + empty_cache: OK", flush=True)
    del g2, out2
except Exception as e:
    print("1c. reuse after all freed + empty_cache: RAISES", type(e).__name__, str(e)[:300], flush=True)
# 1d. two graphs share, drop one, capture third
h = torch.cuda.graph_pool_handle()
ga, oa = capture(f, x, h); gb, ob = capture(f, torch.randn(1 << 21, device=dev), h)
del ga, oa
try:
    gc_, oc = capture(f, torch.randn(1 << 19, device=dev), h); gc_.replay(); gb.replay(); torch.cuda.synchronize()
    print("1d. drop one of two, capture a third: OK", flush=True)
except Exception as e:
    print("1d. RAISES", type(e).__name__, str(e)[:300], flush=True)
torch.cuda.synchronize()

# 2. AdamW capturable with tensor lr; LambdaLR; syncs
model = torch.nn.Linear(64, 64, device=dev)
lr = torch.tensor(1e-2, device=dev)
opt = torch.optim.AdamW(model.parameters(), lr=lr, weight_decay=1e-4, capturable=True)
sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda k: (k + 1) / 10)
print("2. initial_lr", type(opt.param_groups[0]["initial_lr"]), opt.param_groups[0]["initial_lr"] is lr, "lr", opt.param_groups[0]["lr"] is lr, float(lr))
inp = torch.randn(32, 64, device=dev)
def step(inp):
    opt.zero_grad(set_to_none=True)
    loss = model(inp).square().mean()
    loss.backward()
    opt.step()
    return loss.detach()
s = torch.cuda.Stream(); s.wait_stream(torch.cuda.current_stream())
with torch.cuda.stream(s):
    step(inp)
torch.cuda.current_stream().wait_stream(s)
g = torch.cuda.CUDAGraph()
with torch.cuda.graph(g):
    out = step(inp)
for mode in ("error", "warn"):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(mode)
        try:
            sched.step()
            res = "no raise"
        except Exception as e:
            res = f"RAISES {type(e).__name__}: {str(e)[:200]}"
        finally:
            torch.cuda.set_sync_debug_mode(0)
    print(f"2. scheduler.step() under {mode}: {res}; warnings {[str(x.message)[:120] for x in w]}", flush=True)
print("2. lr identity kept:", opt.param_groups[0]["lr"] is lr, float(lr))
# does the replay read the new lr? compare update size to eager clone
before = [p.detach().clone() for p in model.parameters()]
g.replay(); torch.cuda.synchronize()
upd_graph = sum((p - b).norm() ** 2 for p, b in zip(model.parameters(), before)).sqrt().item()
print("2. replay update norm", upd_graph, "lr", float(lr))

# 3. SGD tensor lr under capture
m2 = torch.nn.Linear(8, 8, device=dev)
sgd = torch.optim.SGD(m2.parameters(), lr=torch.tensor(0.1, device=dev))
def sstep(i):
    sgd.zero_grad(set_to_none=True); m2(i).sum().backward(); sgd.step()
i8 = torch.randn(4, 8, device=dev)
s = torch.cuda.Stream(); s.wait_stream(torch.cuda.current_stream())
with torch.cuda.stream(s):
    sstep(i8)
torch.cuda.current_stream().wait_stream(s)
torch.cuda.set_sync_debug_mode("error")
try:
    sstep(i8); print("3. eager SGD tensor lr under sync error: no raise")
except Exception as e:
    print("3. eager SGD tensor lr under sync error: RAISES", type(e).__name__, str(e)[:200])
finally:
    torch.cuda.set_sync_debug_mode(0)
try:
    g3 = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g3):
        sstep(i8)
    print("3. SGD tensor lr capture: OK (!)")
except Exception as e:
    print("3. SGD tensor lr capture: RAISES", type(e).__name__, str(e)[:300])
print("MemPool", hasattr(torch.cuda, "MemPool"))
print("done", flush=True)
