"""Driver 'predictor': batch classification through ``serve.py``'s
``Predictor``, a closed loop with one caller.

Set-up builds the port's model holding the benchmark's values and a
``Predictor`` of the traffic's branch (``ind``), makes the request pool
(NHWC float32 batches, held on the host as NumPy, where a caller's batches
are), and warms the path with requests of the window's shape. In the window
the caller hands the next batch of the pool to ``Predictor.predict`` and
reads its classes to the host, then sends the next. A request's latency
runs from the call to its classes on the host; ``img_s`` is every image
answered over the window's wall time, ``p95_ms`` the 95th percentile of
every request's latency.

A forward hook on the model keeps what the timed path produced: each
request's logits and, on the private branch, each passport block's derived
scale and bias. After the window a sample of its requests, drawn from the
seed, is judged against the reference.
"""

from __future__ import annotations

import random
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.compare import infer_numbers
from portbench.inputs import make_values, request_pool, sub_seed
from portbench.models import build_port_model, leaf_shapes, reference_model
from portbench.reference.resnet import pin_ieee_f32
from portbench.trace import TraceSummary, traced

TINY = {"batch": 4, "pool_batches": 2, "warmup_requests": 1,
        "check_requests": 2, "trace_requests": 2}


class Job:
    unit = "request"
    compare = staticmethod(infer_numbers)

    def __init__(self, config: Dict, traffic: Dict, seed: int,
                 device: torch.device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = device
        self.ind = traffic["ind"]

    def setup(self) -> None:
        from deepipr_tpu_torch.serve import Predictor

        t, dev, c = self.traffic, self.device, self.config
        clock = time.perf_counter()
        values = make_values(leaf_shapes(c), self.seed, dev)
        self.model = build_port_model(c, t["dtype"], values, dev)
        del values
        self.pred = Predictor(self.model, ind=self.ind, device=dev)
        self.pool = request_pool(self.seed, t["pool_batches"], t["batch"],
                                 c["input_size"], c["channels"], dev)
        self.phases = {"build": time.perf_counter() - clock}
        clock = time.perf_counter()
        for i in range(t["warmup_requests"]):
            self._request(i)
        self.phases["warm_up"] = time.perf_counter() - clock
        self.outputs: List = []
        self.hook = self.model.register_forward_hook(self._keep)
        self.sent = 0

    def _keep(self, module, args, out) -> None:
        self.outputs.append((out.logits, {
            path.replace("/", "."): (aux["scale"], aux["bias"])
            for path, aux in out.aux.items()}))

    def _request(self, i: int) -> np.ndarray:
        return self.pred.predict(self.pool[i % len(self.pool)]).cpu().numpy()

    def window(self, seconds: float) -> Dict:
        served, latency = [], []
        t0 = time.perf_counter()
        while True:
            start = time.perf_counter()
            served.append(self._request(self.sent))
            now = time.perf_counter()
            latency.append(now - start)
            self.sent += 1
            if now - t0 >= seconds:
                break
        elapsed = now - t0
        self.served = served
        self.window_outputs = list(self.outputs)
        n, b = len(served), self.traffic["batch"]
        return {"metrics": {"img_s": n * b / elapsed,
                            "p95_ms": 1e3 * float(
                                np.percentile(latency, 95))},
                "attempted": n, "failed": 0, "units": n, "images": n * b,
                "seconds": elapsed}

    def trace(self) -> TraceSummary:
        k = self.traffic["trace_requests"]

        def requests() -> int:
            for _ in range(k):
                self._request(self.sent)
                self.sent += 1
            return k

        return traced(requests, self.device)

    def release(self) -> None:
        """Keep the sample of the window's requests to judge (drawn from the
        seed); free the program's state before the reference runs."""
        self.hook.remove()
        n = len(self.served)
        rng = random.Random(sub_seed(self.seed, "sample"))
        if len(self.window_outputs) != n:
            raise RuntimeError(f"the hook kept {len(self.window_outputs)} "
                               f"outputs of {n} requests")
        picked = sorted(rng.sample(range(n),
                                   min(n, self.traffic["check_requests"])))
        self.sampled = [(i, {"logits": self.window_outputs[i][0],
                             "classes": self.served[i],
                             "affine": self.window_outputs[i][1]})
                        for i in picked]
        del self.model, self.pred, self.outputs, self.window_outputs
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def program_readings(self) -> List[Dict]:
        return [p for _, p in self.sampled]

    @torch.no_grad()
    def reference_readings(self, lower=None) -> List[Dict]:
        """The reference's logits, classes and derived affines of the
        sampled requests; ``lower``: its control."""
        dev = self.device
        pin_ieee_f32()
        values = make_values(leaf_shapes(self.config), self.seed, dev)
        ref = reference_model(self.config, self.traffic["dtype"], values,
                              dev).eval()
        out = []
        for i, _ in self.sampled:
            x = torch.as_tensor(self.pool[i % len(self.pool)], device=dev)
            logits, aux = ref(x.permute(0, 3, 1, 2).contiguous(), self.ind,
                              lower)
            out.append({"logits": logits, "classes": logits.argmax(dim=1),
                        "affine": {k: (a[0], a[1]) for k, a in aux.items()}})
        return out
