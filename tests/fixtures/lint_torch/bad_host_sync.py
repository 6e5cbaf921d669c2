"""Known-bad fixture: GL003 host-sync-in-hot-path (5 findings)."""
import torch


def decode_tokens(engine, steps):
    out = []
    for _ in range(steps):
        tok = engine.step()
        out.append(tok.item())  # BAD: a read on the host per token
        if float(tok) > 3:  # BAD: another in the same loop
            break
        out.append(tok.cpu())  # BAD: a copy to the host per token
    return out


def dispatch_batches(batches, runner):
    done = []
    while batches:
        done.append(runner(batches.pop()).tolist())  # BAD: a read per batch
        torch.cuda.synchronize()  # BAD: drains the queue per batch
    return done
