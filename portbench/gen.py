"""The one traffic generator: reads a mix's data file
(``portbench/traffic/<mix>.json``) and builds one run's request schedule.

Shapes are frozen copies of the port's ``serving/workload.py``: arrivals of
an open loop are a Poisson process at a constant rate (exponential gaps, as
``_poisson_arrivals`` draws them at a constant ``rate_fn``), and tenants
open their prompts with a fixed system prompt of their own followed by a
private suffix (``make_shared_prefix_prompts``, kind "chat"), the tenant
picked by a Zipf law.  Lengths are log-normal, clipped to the mix's range.

Every seed gets the same sizes and arrival gaps, drawn from the mix's
``shape_seed``, in the same order: ``--seed`` draws the token ids (and the
weights), and in a closed loop deals the clients' request sequences out to
the clients in another order.  A seed that reordered the sizes or the gaps
would change the work: near the knee, two seeds of a run whose order was
shuffled within blocks of 8 requests spread 23% in their TTFT tail where
two runs of one seed spread 8% (stablelm-1.6b long-prompt, 30-s windows,
on an H100 80GB HBM3 at 700 W).

Mix keys:
  loop          "open" (requests due on a schedule) or "closed" (``clients``
                each send the next request when the last one finished)
  rate          open loop: requests a second
  lead_in_s     open loop: seconds of the same traffic before the window
  clients       closed loop: client count; client k sends its own sequence
                of requests, one after another
  warm_start    closed loop: each client's first request is one already in
                flight: a uniform share ``u`` of its output is appended to
                its prompt and the rest is left to generate
  prompt        {"median", "sigma", "min", "max"}: log-normal prompt length
  prefix        {"count", "tokens", "zipf_s"}: shared system prompts (the
                prompt length then draws the private suffix)
  output        as ``prompt``, for max_new_tokens
  check         {"requests": n}: requests the correctness check samples
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np

# closed-loop requests drawn ahead for each client
POOL_PER_CLIENT = 64


@dataclasses.dataclass
class Req:
    rid: int
    prompt: List[int]
    max_new: int
    due: Optional[float] = None        # s from the window's start; open loop
    phase: str = "window"              # "lead", "window", "wave"
    tenant: Optional[int] = None


def lengths(spec: Dict, n: int, rng) -> np.ndarray:
    """``n`` log-normal lengths with the spec's median and sigma, clipped
    to [min, max]."""
    x = np.exp(np.log(spec["median"]) + spec["sigma"] * rng.standard_normal(n))
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def gaps(rate: float, seconds: float, rng) -> np.ndarray:
    """Exponential gaps of a Poisson process at ``rate``: every gap whose
    running sum stays below ``seconds``."""
    out: List[float] = []
    t = 0.0
    while True:
        g = float(rng.exponential(1.0 / rate))
        if t + g >= seconds:
            return np.asarray(out)
        t += g
        out.append(g)


def zipf_picks(count: int, s: float, n: int, rng) -> np.ndarray:
    p = 1.0 / np.arange(1, count + 1) ** s
    return rng.choice(count, size=n, p=p / p.sum())


def max_prompt(mix: Dict) -> int:
    return mix["prompt"]["max"] + (mix["prefix"]["tokens"]
                                   if "prefix" in mix else 0)


def max_len(mix: Dict) -> int:
    """The engine's cache length: the longest prompt and output."""
    return max_prompt(mix) + mix["output"]["max"]


class Traffic:
    """One run's requests.  ``tokens(i, n)`` draws request ``i``'s ids;
    prompts are built only when a request is handed out."""

    def __init__(self, mix: Dict, seed: int, vocab: int, seconds: float):
        self.mix, self.seed, self.vocab = mix, seed, vocab
        base = np.random.default_rng(mix.get("shape_seed", 0))
        self.run = np.random.default_rng([seed, 0])
        self._next = 0
        if mix["loop"] == "open":
            lead = mix.get("lead_in_s", 0.0)
            self.schedule: List[Req] = []
            for phase, span, t0 in (("lead", lead, -lead),
                                    ("window", seconds, 0.0)):
                g = gaps(mix["rate"], span, base)
                sizes = self._sizes(len(g), base)
                due = t0 + np.cumsum(g)
                self.schedule += [self._req(sizes, k, float(due[k]), phase)
                                  for k in range(len(g))]
        else:
            n = mix["clients"] * POOL_PER_CLIENT
            self._pool = self._sizes(n, base)
            self._u = base.random(n)
            self._deal = self.run.permutation(mix["clients"])
            self._sent = [0] * mix["clients"]

    def _sizes(self, n: int, rng) -> Dict[str, np.ndarray]:
        mix = self.mix
        s = {"prompt": lengths(mix["prompt"], n, rng),
             "out": lengths(mix["output"], n, rng)}
        if "prefix" in mix:
            p = mix["prefix"]
            s["tenant"] = zipf_picks(p["count"], p["zipf_s"], n, rng)
        return s

    def tokens(self, key, n: int) -> List[int]:
        rng = np.random.default_rng([self.seed, *key])
        return rng.integers(0, self.vocab, n).tolist()

    def system_prompt(self, tenant: int) -> List[int]:
        return self.tokens((2, tenant), self.mix["prefix"]["tokens"])

    def _req(self, sizes, j: int, due=None, phase="window",
             extend: float = 0.0) -> Req:
        rid = self._next
        self._next += 1
        n, out = int(sizes["prompt"][j]), int(sizes["out"][j])
        prompt = self.tokens((1, rid), n)
        tenant = None
        if "tenant" in sizes:
            tenant = int(sizes["tenant"][j])
            prompt = self.system_prompt(tenant) + prompt
        done = int(math.floor(extend * out))
        if done:
            prompt = prompt + self.tokens((3, rid), done)
        return Req(rid, prompt, out - done, due, phase, tenant)

    def next_closed(self, client: int, phase: str = "window") -> Req:
        """Client ``client``'s next request; a ``wave`` request (its first)
        is already a share of its output in flight."""
        i = self._sent[client]
        if i >= POOL_PER_CLIENT:
            raise RuntimeError("a closed-loop client ran out of requests")
        self._sent[client] += 1
        j = int(self._deal[client]) * POOL_PER_CLIENT + i
        extend = float(self._u[j]) if phase == "wave" else 0.0
        return self._req(self._pool, j, phase=phase, extend=extend)
