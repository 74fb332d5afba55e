"""Controller: the exchange-and-compact transition algorithm (§6).

Given the cluster's current deployment and a new target deployment, the
controller plans and executes a transition that is *transparent*: at every
point of the trace, each service's aggregate throughput stays at or above
min(old required, new required) (§1, §6).

**Exchange phase** — fixes instance *sizes* per service.  For each service we
diff instance multisets (Δ_i), pair every new instance with unneeded
instances whose summed throughput does not exceed the new instance's
(pairing the other way could drop throughput, §6), execute each pair
create-first-delete-second (on extra GPUs if no legal room exists), and
delete the remaining unneeded instances only after all pairs finish.

**Compact phase** — fixes device *partitions* and defragments.  Repeatedly
bind one target GPU config to a physical device: migrate away instances the
target does not want, drop idle slots (repartition), migrate wanted
instances in.  Migration is create-then-delete so throughput never dips.
Locality: donors/scratch on the same machine are preferred (§6
"optimizations"); disjoint-GPU actions may run in parallel —
``parallel_makespan`` reports the dependency-aware wall clock.

The port's copy of the JAX package's ``core/controller.py``, op for op: it stays
host numpy/stdlib code, and its seeded output equals the reference's.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cluster import Action, GPUState, SimulatedCluster, parallel_makespan
from repro_torch.core.deployment import Deployment, GPUConfig, Workload
from repro_torch.core.profiles import PerfProfile
from repro_torch.core.rms import ReconfigRules

Content = Tuple[Tuple[int, str], ...]  # sorted ((size, service), ...)


def _config_content(cfg: GPUConfig) -> Counter:
    # memoized on the (frozen) config: transition planning consults target
    # contents O(targets x devices) times
    c = cfg.__dict__.get("_content")
    if c is None:
        c = Counter((a.size, a.service) for a in cfg.assignments if a.service)
        cfg.__dict__["_content"] = c
    return c


def _gpu_content(g: GPUState) -> Counter:
    return Counter((r.size, r.service) for r in g.instances.values() if r.service)


@dataclasses.dataclass
class TransitionReport:
    actions: List[Action]
    serial_seconds: float
    parallel_seconds: float
    peak_gpus_busy: int
    final_gpus_busy: int

    @property
    def action_counts(self) -> Dict[str, int]:
        c: Dict[str, int] = {}
        for a in self.actions:
            c[a.kind] = c.get(a.kind, 0) + 1
        return c


class Controller:
    def __init__(self, rules: ReconfigRules, profile: PerfProfile):
        self.rules = rules
        self.profile = profile

    # -- initial placement -------------------------------------------------------
    def deploy_fresh(
        self, cluster: SimulatedCluster, deployment: Deployment
    ) -> None:
        """Place a deployment on an empty cluster (one config per device)."""
        empties = [
            gid for gid, g in cluster.gpus.items()
            if not g.instances and cluster.schedulable(gid)
        ]
        if len(empties) < deployment.num_gpus:
            cluster.grow(deployment.num_gpus - len(empties))
            empties = [
                gid for gid, g in cluster.gpus.items()
                if not g.instances and cluster.schedulable(gid)
            ]
        for cfg, gid in zip(deployment.configs, empties):
            for a in cfg.assignments:
                if a.service is None:
                    continue
                cluster.apply(
                    Action("create", gid, size=a.size, service=a.service,
                           throughput=a.throughput)
                )

    # -- exchange phase ------------------------------------------------------------
    def _exchange(
        self,
        cluster: SimulatedCluster,
        new_dep: Deployment,
        services_per_round: Optional[int] = None,
    ) -> None:
        # target / current per-service multisets of (size, throughput-per-inst)
        new_insts: Dict[str, List[Tuple[int, float]]] = {}
        for cfg in new_dep.configs:
            for a in cfg.assignments:
                if a.service:
                    new_insts.setdefault(a.service, []).append((a.size, a.throughput))
        cur_insts: Dict[str, List[Tuple[int, int, float, int]]] = {}
        for gid, g in cluster.gpus.items():
            for r in g.instances.values():
                if r.service:
                    cur_insts.setdefault(r.service, []).append(
                        (r.size, gid, r.throughput, r.uid)
                    )

        # sorted, as in the reference: set order would vary the plan
        services = sorted(set(new_insts) | set(cur_insts))

        # -- plan per service: expanded creates + the unneeded pool -----------
        plans: Dict[str, Tuple[List[Tuple[int, float]], List[Tuple[int, int, float, int]]]] = {}
        for svc in services:
            want = Counter(s for s, _ in new_insts.get(svc, []))
            have = Counter(s for s, _, _, _ in cur_insts.get(svc, []))
            plus = want - have  # sizes to create
            minus = have - want  # sizes to drop
            # concrete unneeded instances, largest throughput first
            unneeded = sorted(
                (t for t in cur_insts.get(svc, []) if minus[t[0]] > 0),
                key=lambda t: -t[2],
            )
            picked: List[Tuple[int, int, float, int]] = []
            tally = Counter()
            for t in unneeded:
                if tally[t[0]] < minus[t[0]]:
                    picked.append(t)
                    tally[t[0]] += 1
            # new instances, largest first; multiplicity-expanded
            new_list = sorted(
                ((size, tput) for size, tput in new_insts.get(svc, []) if plus[size] > 0),
                key=lambda t: -t[1],
            )
            expanded: List[Tuple[int, float]] = []
            counted = Counter()
            for size, tput in new_list:
                if counted[size] < plus[size]:
                    expanded.append((size, tput))
                    counted[size] += 1
            plans[svc] = (expanded, picked)

        # -- execute in rounds (§6: granularity depends on extra GPUs) --------
        # Within a round, services' pairs are interleaved round-robin so that
        # actions on disjoint GPUs can run in parallel; a smaller
        # services_per_round bounds how many in-flight creations (hence extra
        # GPUs) exist at once.
        r = services_per_round or len(services)
        for lo in range(0, len(services), max(1, r)):
            chunk = services[lo : lo + max(1, r)]
            pending = {svc: list(plans[svc][0]) for svc in chunk}
            unneeded_pool = {svc: list(plans[svc][1]) for svc in chunk}
            while any(pending.values()):
                for svc in chunk:
                    if not pending[svc]:
                        continue
                    size, tput = pending[svc].pop(0)
                    gid = cluster.find_room(size)
                    if gid is None:
                        gid = cluster.grow(1)[0]
                    cluster.apply(
                        Action("create", gid, size=size, service=svc, throughput=tput)
                    )
                    # delete paired unneeded instances (sum tput <= new tput)
                    budget = tput
                    rest: List[Tuple[int, int, float, int]] = []
                    for t in unneeded_pool[svc]:
                        if t[2] <= budget + 1e-9:
                            cluster.apply(Action("delete", t[1], uid=t[3]))
                            budget -= t[2]
                        else:
                            rest.append(t)
                    unneeded_pool[svc] = rest
            # leftovers deleted only after all pairs of the round finished —
            # every service's throughput stays >= min(old, new) throughout
            for svc in chunk:
                for t in unneeded_pool[svc]:
                    cluster.apply(Action("delete", t[1], uid=t[3]))

    # -- compact phase ---------------------------------------------------------------
    def _find_scratch(
        self, cluster: SimulatedCluster, size: int, avoid: Sequence[int],
        near_machine: Optional[int],
    ) -> int:
        """A non-avoided, schedulable GPU that can legally host a ``size``
        instance, preferring the local machine (§6 locality optimization)."""
        avoid_set = set(avoid)
        cands = [
            gid for gid in cluster.gpus
            if gid not in avoid_set and cluster.schedulable(gid)
        ]
        cands.sort(key=lambda gid: (cluster.gpus[gid].machine != near_machine, gid))
        for gid in cands:
            part = tuple(sorted(cluster.gpus[gid].partition() + (size,)))
            if self.rules.is_legal_partition(part):
                return gid
        return cluster.grow(1)[0]

    def _compact(self, cluster: SimulatedCluster, new_dep: Deployment) -> None:
        targets: List[GPUConfig] = list(new_dep.configs)
        bound: Dict[int, int] = {}  # target idx -> gpu id

        def unbound_gpus() -> List[int]:
            """Donor-eligible devices: unbound, not failed (draining devices
            still *donate* instances — that is how a drain empties out)."""
            taken = set(bound.values())
            return [
                gid for gid in cluster.gpus
                if gid not in taken and gid not in cluster.failed
            ]

        def bindable_gpus() -> List[int]:
            """Target-eligible devices: unbound AND schedulable (a target
            config must never be shaped onto a failed or draining device)."""
            return [gid for gid in unbound_gpus() if cluster.schedulable(gid)]

        # 1) bind exact matches first (no actions run here, so per-GPU
        # contents can be computed once for the whole pass)
        contents = {gid: _gpu_content(g) for gid, g in cluster.gpus.items()}
        for ti, cfg in enumerate(targets):
            want = _config_content(cfg)
            for gid in bindable_gpus():
                if contents[gid] == want:
                    bound[ti] = gid
                    break

        # 2) one target at a time: shape a device into the target config
        for ti, cfg in enumerate(targets):
            if ti in bound:
                continue
            want = _config_content(cfg)
            # pick the unbound GPU with the most overlap; contents are
            # re-read per target (the previous target's migrations moved
            # instances) but only once per candidate, not per comparison
            cands = bindable_gpus()
            if not cands:
                # every healthy device is bound (fault domains shrank the
                # cluster mid-transition) — provision a fresh one
                cands = cluster.grow(1)
            contents = {gid: _gpu_content(cluster.gpus[gid]) for gid in cands}

            def overlap(gid: int) -> int:
                return sum((contents[gid] & want).values())

            gid = max(cands, key=overlap)
            g = cluster.gpus[gid]
            taken = set(bound.values()) | {gid}
            # 2a) migrate away busy instances the target does not want
            surplus = _gpu_content(g) - want
            for (size, svc), cnt in list(surplus.items()):
                uids = [
                    u for u, r in g.instances.items()
                    if r.size == size and r.service == svc
                ][:cnt]
                for uid in uids:
                    dst = self._find_scratch(cluster, size, avoid=taken,
                                             near_machine=g.machine)
                    cluster.apply(Action("migrate", gid, uid=uid, dst_gpu=dst))
            # 2b) drop idle slots so incoming instances always fit
            idle = tuple(u for u, r in g.instances.items() if r.service is None)
            if idle:
                cluster.apply(Action("repartition", gid, remove_uids=idle))
            # 2c) migrate wanted instances in (locality-aware donor order)
            missing = want - _gpu_content(g)
            for (size, svc), cnt in sorted(missing.items(), key=lambda kv: -kv[0][0]):
                for _ in range(cnt):
                    donor = None
                    donors = sorted(
                        (d for d in unbound_gpus() if d != gid),
                        key=lambda d: (cluster.gpus[d].machine != g.machine, d),
                    )
                    for d in donors:
                        for u, r in cluster.gpus[d].instances.items():
                            if r.size == size and r.service == svc:
                                donor = (d, u)
                                break
                        if donor:
                            break
                    if donor is None:
                        raise RuntimeError(
                            f"compact: no donor for ({size},{svc}) — "
                            "exchange phase left wrong multiset"
                        )
                    cluster.apply(Action("migrate", donor[0], uid=donor[1], dst_gpu=gid))
            bound[ti] = gid

        # 3) clear idle slots on non-target GPUs (skip failed/draining
        # devices: no point reconfiguring hardware that is gone or leaving)
        taken = set(bound.values())
        for gid, g in cluster.gpus.items():
            if gid in taken:
                continue
            if g.busy():
                raise RuntimeError(
                    f"compact left a running instance unplaced on gpu{gid}"
                )
            if not cluster.schedulable(gid):
                continue
            idle = tuple(g.instances)
            if idle:
                cluster.apply(Action("repartition", gid, remove_uids=idle))

    # -- incremental transition (warm-start targets) -------------------------------
    def transition_incremental(
        self, cluster: SimulatedCluster, new_dep: Deployment
    ) -> TransitionReport:
        """Delta-aware transition for warm-start targets.

        The warm optimizer bounds the edit distance between the running
        deployment and the target, so most devices already hold exactly one
        target config — the full exchange-and-compact would re-derive that
        with O(cluster) scans per action.  Instead: (1) bind every device
        whose content equals a target config (no actions at all), (2) create
        each remaining target config whole on an empty device (grown on
        demand, like ``deploy_fresh``), and (3) only after every create has
        landed, drain the surplus devices (delete busy instances, then
        repartition the idle slots away so the device is reusable).  Creates
        strictly before deletes keeps every service's aggregate throughput
        >= min(old, new) required at all times — the §6 transparency
        guarantee — and the action count is O(edit distance), not
        O(cluster).  Trade-off vs exchange-and-compact: peak extra devices
        during the transition can reach old+new for a wildly different
        target, which is why callers route only bounded-edit (warm) targets
        here.
        """
        start_idx = len(cluster.actions_applied)
        peak = cluster.gpus_in_use()
        # 1) exact-content binding, like compact step 1
        by_content: Dict[Content, List[int]] = {}
        for gid in sorted(cluster.gpus):
            g = cluster.gpus[gid]
            if g.busy() and cluster.schedulable(gid):
                key = tuple(sorted(_gpu_content(g).items()))
                by_content.setdefault(key, []).append(gid)
        unmatched: List[GPUConfig] = []
        for cfg in new_dep.configs:
            key = tuple(sorted(_config_content(cfg).items()))
            gids = by_content.get(key)
            if gids:
                gids.pop(0)  # bound: already serving this exact config
            else:
                unmatched.append(cfg)
        surplus = sorted(gid for gids in by_content.values() for gid in gids)
        # 2) create phase: each unmatched target lands whole on an empty device
        empties = sorted(
            gid
            for gid, g in cluster.gpus.items()
            if not g.instances and cluster.schedulable(gid)
        )
        if len(empties) < len(unmatched):
            empties += cluster.grow(len(unmatched) - len(empties))
        for cfg, gid in zip(unmatched, empties):
            for a in cfg.assignments:
                if a.service is None:
                    continue
                cluster.apply(
                    Action("create", gid, size=a.size, service=a.service,
                           throughput=a.throughput)
                )
        peak = max(peak, cluster.gpus_in_use())
        # 3) drain surplus devices — strictly after all creates
        for gid in surplus:
            g = cluster.gpus[gid]
            for uid in sorted(u for u, r in g.instances.items() if r.service):
                cluster.apply(Action("delete", gid, uid=uid))
            idle = tuple(sorted(g.instances))
            if idle:
                cluster.apply(Action("repartition", gid, remove_uids=idle))
        actions = cluster.actions_applied[start_idx:]
        return TransitionReport(
            actions=actions,
            serial_seconds=sum(a.seconds() for a in actions),
            parallel_seconds=parallel_makespan(actions),
            peak_gpus_busy=peak,
            final_gpus_busy=cluster.gpus_in_use(),
        )

    # -- end-to-end ---------------------------------------------------------------
    def transition(
        self,
        cluster: SimulatedCluster,
        new_dep: Deployment,
        services_per_round: Optional[int] = None,
    ) -> TransitionReport:
        """``services_per_round`` (§6): with many extra GPUs, run
        exchange-and-compact once for all services (None); with few, bound
        the number of services in flight per round."""
        start_idx = len(cluster.actions_applied)
        peak = cluster.gpus_in_use()
        self._exchange(cluster, new_dep, services_per_round)
        peak = max(peak, cluster.gpus_in_use())
        self._compact(cluster, new_dep)
        peak = max(peak, cluster.gpus_in_use())
        actions = cluster.actions_applied[start_idx:]
        return TransitionReport(
            actions=actions,
            serial_seconds=sum(a.seconds() for a in actions),
            parallel_seconds=parallel_makespan(actions),
            peak_gpus_busy=peak,
            final_gpus_busy=cluster.gpus_in_use(),
        )
