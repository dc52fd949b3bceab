"""Prefix-affinity fleet routing: make N replicas one KV cache.

The port of ``mmlspark_tpu/serve/affinity.py`` (hashlib only, so every
assignment equals the reference's). Each replica's shared-prefix KV cache
is its own; this module lets the router score replicas by the prefix
blocks they already hold, WITHOUT moving any KV bytes:

- **Advertisement.** Each replica summarizes its resident prefix-block
  hash chains (the chained sha256 keys minted by
  :func:`~mmlspark_tpu_torch.serve.kvcache.prefix_block_hashes`) into a
  bounded top-K digest — ``KVCacheManager.stats()['resident_chains']``,
  ``generate.advertise_top_k`` entries of ``(chain hash, depth, hashes,
  leases, hits, last_use)``. The digest rides the stats surface
  (in-process ``server.stats()``; ``GET /affinity`` over HTTP) and is
  pulled fleet-wide by the
  :class:`~mmlspark_tpu_torch.observability.aggregate.FleetScraper` into
  one shared :class:`AffinityState`.
- **Scoring.** For each generate request the router hashes the prompt's
  block chain host-side (same ``(model, kv_dtype, block_tokens)`` seed
  the replicas advertise) and walks every READY replica's digest: a
  replica's score is the deepest common prefix between the prompt's
  chain and any advertised chain — the expected prefix-hit depth in
  blocks. The deepest replica wins; ties (and scores below
  ``fleet.affinity_min_depth``) fall back to the smooth-WRR spread.
- **Session affinity.** Traffic carrying a ``session`` key is
  consistent-hashed onto the READY ring (``fleet.affinity_vnodes``
  virtual nodes per replica, seeded by ``fleet.affinity_seed``).
- **Safety overrides affinity, always.** Selection only ever happens
  among the router's safe candidate set (ready, positive weight, not
  breaker-open, not already tried by this request). On failover the
  dead replica is excluded and the survivors are RE-scored, so the
  restarted sequence lands on the warmest survivor.
- **Rollout pre-warm.** The hottest observed prompt prefixes are
  retained host-side (tokens, not KV) so ``Fleet.rollout`` can replay
  them through a canary's prefill before it takes weight.
"""
from __future__ import annotations

import bisect
import hashlib
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from mmlspark_tpu_torch.observability import events, metrics
from mmlspark_tpu_torch.serve.kvcache import prefix_block_hashes
from mmlspark_tpu_torch.utils import config as mmlconfig
from mmlspark_tpu_torch.utils.logging import get_logger

logger = get_logger("serve.affinity")


class PrefixDigest:
    """One replica's advertised resident-chain summary for one model.

    ``chains`` is the bounded top-K list straight from
    ``KVCacheManager.resident_chains()``; ``kv_dtype``/``block_tokens``
    are the hash-seed parameters a consumer needs to re-derive a
    prompt's chain with the same keys the replica minted."""

    __slots__ = ("replica", "model", "chains", "kv_dtype", "block_tokens",
                 "ts")

    def __init__(self, replica: str, model: str,
                 chains: Sequence[Dict[str, Any]], *,
                 kv_dtype: str = "", block_tokens: int = 0,
                 ts: float = 0.0):
        self.replica = str(replica)
        self.model = str(model)
        self.chains = [dict(c) for c in chains]
        self.kv_dtype = str(kv_dtype or "")
        self.block_tokens = int(block_tokens or 0)
        self.ts = float(ts)

    def max_depth(self) -> int:
        return max((int(c.get("depth", 0)) for c in self.chains), default=0)

    def to_dict(self) -> Dict[str, Any]:
        return {"replica": self.replica, "model": self.model,
                "chains": self.chains, "kv_dtype": self.kv_dtype,
                "block_tokens": self.block_tokens, "ts": self.ts}


def score_digest(digest: Optional[PrefixDigest],
                 prompt_hashes: Sequence[str]) -> int:
    """Expected prefix-hit depth (in blocks) of ``prompt_hashes`` on the
    replica behind ``digest``: the deepest common prefix between the
    prompt's chain and any advertised chain. Chained hashes make the
    walk exact — position i matches iff the ENTIRE prefix through block
    i is identical."""
    if digest is None or not prompt_hashes:
        return 0
    best = 0
    for c in digest.chains:
        depth = 0
        for adv, want in zip(c.get("hashes") or (), prompt_hashes):
            if adv != want:
                break
            depth += 1
        if depth > best:
            best = depth
    return best


class ConsistentHashRing:
    """Seeded consistent-hash ring over replica names.

    Each name contributes ``vnodes`` deterministic points (sha256 of
    ``seed|name|i``); a key lands on the first point clockwise of its
    own hash. Deterministic under seed, and stable under membership
    change: adding or retiring one replica only moves the keys whose
    nearest point belonged to it."""

    def __init__(self, names: Sequence[str], *,
                 vnodes: Optional[int] = None,
                 seed: Optional[int] = None):
        self.vnodes = int(vnodes if vnodes is not None
                          else mmlconfig.get("fleet.affinity_vnodes"))
        self.seed = int(seed if seed is not None
                        else mmlconfig.get("fleet.affinity_seed"))
        if self.vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {self.vnodes}")
        points: List[Tuple[int, str]] = []
        for name in sorted(set(names)):
            for i in range(self.vnodes):
                points.append((self._point(f"{self.seed}|{name}|{i}"),
                               name))
        points.sort()
        self._points = points
        self._keys = [p[0] for p in points]

    @staticmethod
    def _point(text: str) -> int:
        return int(hashlib.sha256(text.encode()).hexdigest()[:16], 16)

    def assign(self, key: str) -> Optional[str]:
        """The replica owning ``key``, or None on an empty ring."""
        if not self._points:
            return None
        h = self._point(f"k|{key}")
        i = bisect.bisect_right(self._keys, h)
        if i == len(self._points):
            i = 0                       # wrap past the top of the ring
        return self._points[i][1]


class AffinityHint:
    """Per-request routing context threaded from ``submit_generate``
    down to the pick: the prompt's chained block hashes (when the hash
    params are known from a digest) and the caller's session key."""

    __slots__ = ("model", "hashes", "session")

    def __init__(self, model: str, hashes: Optional[List[str]] = None,
                 session: Optional[str] = None):
        self.model = model
        self.hashes = hashes or []
        self.session = session


class _HotPrompt:
    """Heat-map entry for rollout pre-warm: the full-block token prefix
    behind one observed chain, with a hit count."""

    __slots__ = ("tokens", "hits")

    def __init__(self, tokens: List[int]):
        self.tokens = tokens
        self.hits = 0


class AffinityState:
    """Fleet-wide digest registry + routing scorer (thread-safe).

    One instance is shared between the :class:`~mmlspark_tpu_torch.serve.
    router.Router` (which calls :meth:`select` per generate pick) and
    the :class:`~mmlspark_tpu_torch.observability.aggregate.FleetScraper`
    (which calls :meth:`update_digest` per scrape). No KV bytes move:
    the state is hash chains and counters only."""

    def __init__(self, *, enabled: Optional[bool] = None,
                 min_depth: Optional[int] = None,
                 vnodes: Optional[int] = None,
                 seed: Optional[int] = None,
                 hot_prompts: int = 32):
        self.enabled = bool(mmlconfig.get("fleet.affinity_enabled")
                            if enabled is None else enabled)
        self.min_depth = int(mmlconfig.get("fleet.affinity_min_depth")
                             if min_depth is None else min_depth)
        self._vnodes = vnodes
        self._seed = seed
        self._lock = threading.Lock()
        # (replica, model) -> PrefixDigest
        self._digests: Dict[Tuple[str, str], PrefixDigest] = {}
        # model -> (kv_dtype, block_tokens) learned from advertisements
        self._hash_params: Dict[str, Tuple[str, int]] = {}
        # model -> {tail hash -> _HotPrompt} (bounded, for pre-warm)
        self._hot: Dict[str, Dict[str, _HotPrompt]] = {}
        self._hot_cap = int(hot_prompts)
        self._rings: Dict[Tuple[str, ...], ConsistentHashRing] = {}
        self.routes_prefix = 0
        self.routes_session = 0
        self.routes_wrr = 0
        self.spills = 0             # picks bounced off a loaded leader
        self.depth_hist: Dict[int, int] = {}

    # -- advertisement -----------------------------------------------------
    def update_digest(self, replica: str, model: str,
                      chains: Sequence[Dict[str, Any]], *,
                      kv_dtype: Any = None, block_tokens: Any = None,
                      ts: float = 0.0) -> None:
        """Publish one replica's scraped chain summary for ``model``."""
        d = PrefixDigest(replica, model, chains,
                         kv_dtype=str(kv_dtype or ""),
                         block_tokens=int(block_tokens or 0), ts=ts)
        with self._lock:
            self._digests[(d.replica, d.model)] = d
            if d.kv_dtype and d.block_tokens:
                self._hash_params[d.model] = (d.kv_dtype, d.block_tokens)
        if events.recording_enabled():
            events.emit("affinity", "advertise", replica=d.replica,
                        model=d.model, chains=len(d.chains),
                        max_depth=d.max_depth())
        if metrics.metrics_enabled():
            metrics.gauge(
                f"affinity.advertised_chains.{d.replica}").set(
                    float(len(d.chains)))

    def forget(self, replica: str) -> None:
        """Drop a retired replica's digests (its chains died with it)."""
        with self._lock:
            for key in [k for k in self._digests if k[0] == replica]:
                del self._digests[key]

    def digest_for(self, replica: str, model: str
                   ) -> Optional[PrefixDigest]:
        with self._lock:
            return self._digests.get((replica, model))

    # -- request-side hashing ----------------------------------------------
    def hint_for(self, model: str, prompt: Sequence[int],
                 session: Optional[str] = None
                 ) -> Optional[AffinityHint]:
        """Build the routing hint for one generate request: hash the
        prompt's block chain host-side with the SAME seed the replicas
        advertise. Before any digest has arrived (cold fleet, scraper
        not running) the hash params are unknown — the hint then
        carries only the session key, and routing is pure WRR."""
        if not self.enabled:
            return None
        with self._lock:
            params = self._hash_params.get(model)
        hashes: List[str] = []
        if params is not None:
            kv_dtype, bt = params
            hashes = prefix_block_hashes(model, kv_dtype, prompt, bt)
            if hashes:
                self._observe_prompt(model, hashes, list(prompt), bt)
        if not hashes and not session:
            return None
        return AffinityHint(model, hashes, session)

    def _observe_prompt(self, model: str, hashes: List[str],
                        prompt: List[int], block_tokens: int) -> None:
        """Track the hottest full-block prompt prefixes (tokens, host
        RAM only) so a rollout canary can replay them through prefill."""
        tail = hashes[-1]
        tokens = prompt[:len(hashes) * block_tokens]
        with self._lock:
            heat = self._hot.setdefault(model, {})
            hp = heat.get(tail)
            if hp is None:
                if len(heat) >= self._hot_cap:
                    # LFU: the coldest entry makes room (hot chains have
                    # accumulated hits and survive one-off prompts)
                    del heat[min(heat, key=lambda k: heat[k].hits)]
                hp = heat[tail] = _HotPrompt(tokens)
            hp.hits += 1

    def hot_prompts(self, model: str, limit: int) -> List[List[int]]:
        """The ``limit`` hottest full-block prompt prefixes observed for
        ``model``, hottest first — the rollout pre-warm replay set."""
        if limit <= 0:
            return []
        with self._lock:
            heat = self._hot.get(model, {})
            ranked = sorted(heat.values(), key=lambda hp: -hp.hits)
            return [list(hp.tokens) for hp in ranked[:int(limit)]]

    # -- selection ---------------------------------------------------------
    def select(self, candidates: Sequence[str], hint: AffinityHint
               ) -> Tuple[List[str], str, int]:
        """Narrow the router's SAFE candidate set for one pick.

        Returns ``(names, mode, depth)``: the (sub)set to run the
        smooth-WRR spread over, how it was chosen (``session`` /
        ``prefix`` / ``wrr``), and the expected hit depth in blocks.
        ``candidates`` has already been filtered to ready, positive-
        weight, non-excluded replicas — affinity only ever reorders
        WITHIN that set, so a breaker-open, draining, shedding, or
        already-tried replica is never chosen to chase a cache hit."""
        names = list(candidates)
        if not self.enabled or not names:
            return names, "wrr", 0
        if hint.session:
            ring_key = tuple(sorted(names))
            with self._lock:
                ring = self._rings.get(ring_key)
                if ring is None:
                    ring = ConsistentHashRing(
                        names, vnodes=self._vnodes, seed=self._seed)
                    if len(self._rings) > 64:   # membership-churn bound
                        self._rings.clear()
                    self._rings[ring_key] = ring
            owner = ring.assign(hint.session)
            if owner is not None:
                depth = 0
                if hint.hashes:
                    depth = score_digest(
                        self.digest_for(owner, hint.model), hint.hashes)
                return [owner], "session", depth
        if hint.hashes:
            scores = {n: score_digest(self.digest_for(n, hint.model),
                                      hint.hashes) for n in names}
            best = max(scores.values())
            if best >= max(1, self.min_depth):
                leaders = [n for n in names if scores[n] == best]
                return leaders, "prefix", best
        return names, "wrr", 0

    # -- accounting --------------------------------------------------------
    def observe_route(self, replica: str, mode: str, depth: int) -> None:
        """Count one routed generate request (the affinity-vs-WRR split
        and the fleet hit-depth histogram in reports/top)."""
        with self._lock:
            if mode == "prefix":
                self.routes_prefix += 1
            elif mode == "session":
                self.routes_session += 1
            else:
                self.routes_wrr += 1
            d = int(depth)
            self.depth_hist[d] = self.depth_hist.get(d, 0) + 1
        if events.recording_enabled():
            events.emit("affinity", "route", replica=replica, mode=mode,
                        depth=int(depth))

    def observe_spill(self) -> None:
        """Count one bounded-load spill: affinity had a leader but every
        copy of it was over the in-flight cap, so the pick fell back to
        WRR (the route itself is then counted as a WRR route)."""
        with self._lock:
            self.spills += 1
        if events.recording_enabled():
            events.emit("affinity", "spill")

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            total = (self.routes_prefix + self.routes_session
                     + self.routes_wrr)
            return {
                "enabled": self.enabled,
                "routes": total,
                "routes_prefix": self.routes_prefix,
                "routes_session": self.routes_session,
                "routes_wrr": self.routes_wrr,
                "affinity_route_share": round(
                    (self.routes_prefix + self.routes_session)
                    / total, 4) if total else 0.0,
                "spills": self.spills,
                "depth_hist": dict(sorted(self.depth_hist.items())),
                "digests": len(self._digests),
            }

    def snapshot(self) -> Dict[str, Any]:
        """The scraper/dashboard view: routing split + per-replica
        advertised chains."""
        out = self.stats()
        with self._lock:
            out["advertised"] = [
                {"replica": d.replica, "model": d.model,
                 "chains": len(d.chains), "max_depth": d.max_depth(),
                 "leases": sum(int(c.get("leases", 0))
                               for c in d.chains)}
                for d in sorted(self._digests.values(),
                                key=lambda d: (d.replica, d.model))]
        return out
