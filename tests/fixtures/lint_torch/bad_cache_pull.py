"""Known-bad fixture: GL005 cache-pull-in-hot-loop (3 findings)."""


class Engine:
    def decode_stream(self, steps):
        out = []
        for _ in range(steps):
            snap = self.kv_cache.cpu()  # BAD: whole cache to the host per token
            out.append(snap[0, 0])
        return out

    def dispatch_slots(self, requests):
        done = []
        while requests:
            req = requests.pop()
            done.append(req.cache.numpy())  # BAD: materialized per slot
            done.append(self.k_cache[0].tolist())  # BAD: a layer's cache per request
        return done
