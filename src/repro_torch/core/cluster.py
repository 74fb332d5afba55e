"""Simulated GPU cluster and the controller's action vocabulary (§4, §6).

The controller's four action types — instance creation, deletion, migration
(local/remote), and device repartition — are implemented against an
in-memory cluster state with the paper's measured action latencies
(Figure 13c).  On the real system these would be k8s operations (§7); here
the actuation layer is simulated while the planning algorithm
is implemented exactly.

The port's copy of the JAX package's ``core/cluster.py``.  The fault
hooks below serve that package's control plane (``repro.controlplane``),
which the port does not have yet.

The cluster records a **throughput trace**: after every applied action, the
per-service aggregate throughput.  The controller's transparency guarantee —
during a transition every service's throughput stays ≥ min(old, new)
required throughput (§1, §6) — is asserted from this trace by the tests.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.rms import Partition, ReconfigRules

# Action latencies in seconds, read off the paper's Figure 13c.  This is
# the port's one copy — the controller and the tests import it from here.
ACTION_SECONDS = {
    "create": 62.0,
    "delete": 2.0,
    "repartition": 1.0,
    "migrate_local": 64.0,
    "migrate_remote": 70.0,
}

GPUS_PER_MACHINE = 8  # the paper's testbed machines hold 8 A100s each


class ActionFault(RuntimeError):
    """An injected fault: the action attempt failed *atomically* — cluster
    state is unchanged, but ``wasted_s`` seconds of wall clock were burned
    on the attempt.  Raised out of :meth:`SimulatedCluster.apply` when a
    fault hook (the control plane's fault injector) vetoes the action; the
    reconciler catches it, backs off, and re-plans."""

    def __init__(self, action: "Action", reason: str, wasted_s: float):
        super().__init__(
            f"{action.kind} on gpu{action.gpu} failed: {reason}"
        )
        self.action = action
        self.reason = reason
        self.wasted_s = wasted_s


@dataclasses.dataclass
class InstanceRec:
    uid: int
    size: int
    service: Optional[str]
    throughput: float = 0.0


@dataclasses.dataclass
class GPUState:
    gpu_id: int
    instances: Dict[int, InstanceRec] = dataclasses.field(default_factory=dict)

    @property
    def machine(self) -> int:
        return self.gpu_id // GPUS_PER_MACHINE

    def partition(self) -> Partition:
        return tuple(sorted(r.size for r in self.instances.values()))

    def busy(self) -> bool:
        return any(r.service for r in self.instances.values())


# -- actions -------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Action:
    kind: str  # create | delete | repartition | migrate
    gpu: int
    size: int = 0
    service: Optional[str] = None
    throughput: float = 0.0
    uid: int = -1
    dst_gpu: int = -1  # migrate only
    add_sizes: Tuple[int, ...] = ()  # repartition only
    remove_uids: Tuple[int, ...] = ()  # repartition only

    def seconds(self) -> float:
        if self.kind == "migrate":
            local = (
                self.gpu // GPUS_PER_MACHINE == self.dst_gpu // GPUS_PER_MACHINE
            )
            return ACTION_SECONDS["migrate_local" if local else "migrate_remote"]
        return ACTION_SECONDS[self.kind]

    def gpus_touched(self) -> Tuple[int, ...]:
        return (self.gpu, self.dst_gpu) if self.kind == "migrate" else (self.gpu,)


class SimulatedCluster:
    """In-memory cluster with legality enforcement and a throughput trace."""

    def __init__(self, rules: ReconfigRules, n_gpus: int):
        self.rules = rules
        self.gpus: Dict[int, GPUState] = {i: GPUState(i) for i in range(n_gpus)}
        self._uid = itertools.count()
        # uid -> home device, for every uid ever minted (uids never move:
        # migration mints a fresh uid on the destination).  The control
        # plane consults this on device failure to also kill uids that only
        # survive inside in-flight transition timelines.
        self.uid_gpu: Dict[int, int] = {}
        self.trace: List[Tuple[float, Dict[str, float]]] = []
        # instance-level twin of ``trace``: after every action, the busy
        # instances as {uid: (service, size, throughput)}.  The closed-loop
        # simulator replays this to charge action latencies to
        # in-flight serving capacity; opt-in because it costs an
        # O(busy-instances) snapshot per action and only the simulator reads it.
        self.record_instance_trace = False
        self.instance_trace: List[Tuple[float, Dict[int, Tuple[str, int, float]]]] = []
        self.clock = 0.0
        self.actions_applied: List[Action] = []
        # actual seconds charged per applied action (== Action.seconds()
        # unless a fault hook stretched it — stragglers); same indexing as
        # actions_applied, so makespan recomputation can honor stragglers
        self.applied_seconds: List[float] = []
        # fault domains (the control plane): failed devices are gone for
        # good (instances lost, never schedulable again); draining devices
        # keep serving but accept no new placements until emptied; cordoned
        # machines accept no new devices (grow skips them)
        self.failed: set = set()
        self.draining: set = set()
        self.cordoned: set = set()
        # optional fault injection point (the control plane's faults): called
        # with each action before it mutates state; returns a latency
        # multiplier (stragglers) or raises ActionFault (botched attempt)
        self.fault_hook = None

    # -- queries ----------------------------------------------------------------
    def busy_instances(self) -> Dict[int, Tuple[str, int, float]]:
        """The currently serving instances: uid -> (service, size, req/s)."""
        out: Dict[int, Tuple[str, int, float]] = {}
        for g in self.gpus.values():
            for r in g.instances.values():
                if r.service:
                    out[r.uid] = (r.service, r.size, r.throughput)
        return out

    def throughput(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for g in self.gpus.values():
            for r in g.instances.values():
                if r.service:
                    out[r.service] = out.get(r.service, 0.0) + r.throughput
        return out

    def schedulable(self, gid: int) -> bool:
        """May new work land on this device? (not failed, not draining)"""
        return gid not in self.failed and gid not in self.draining

    def find_room(self, size: int, prefer: Sequence[int] = ()) -> Optional[int]:
        """A GPU that can legally add a ``size`` instance right now."""
        order = list(prefer) + [g for g in self.gpus if g not in prefer]
        for gid in order:
            if not self.schedulable(gid):
                continue
            cand = tuple(sorted(self.gpus[gid].partition() + (size,)))
            if self.rules.is_legal_partition(cand):
                return gid
        return None

    def grow(self, n: int = 1) -> List[int]:
        new_ids = []
        base = max(self.gpus) + 1 if self.gpus else 0
        for _ in range(n):
            # never provision onto a cordoned machine (node drain, §7)
            while base // GPUS_PER_MACHINE in self.cordoned:
                base = (base // GPUS_PER_MACHINE + 1) * GPUS_PER_MACHINE
            self.gpus[base] = GPUState(base)
            new_ids.append(base)
            base += 1
        return new_ids

    def gpus_in_use(self) -> int:
        return sum(1 for g in self.gpus.values() if g.busy())

    def machine_gpus(self, machine: int) -> List[int]:
        return [gid for gid, g in self.gpus.items() if g.machine == machine]

    # -- fault domains (the control plane) --------------------------------------
    def _note_state(self) -> None:
        self.trace.append((self.clock, self.throughput()))
        if self.record_instance_trace:
            self.instance_trace.append((self.clock, self.busy_instances()))

    def fail_gpu(self, gid: int) -> List[int]:
        """Whole-device failure: every instance on the device vanishes
        instantly (no graceful latency — this is the fault, not an action)
        and the device never schedules again.  Returns the killed uids."""
        g = self.gpus[gid]
        killed = sorted(g.instances)
        g.instances.clear()
        self.failed.add(gid)
        self.draining.discard(gid)
        self._note_state()
        return killed

    def drain_gpu(self, gid: int) -> None:
        """Mark a device draining: its instances keep serving, but nothing
        new lands on it.  The reconciler migrates the survivors off."""
        if gid not in self.failed:
            self.draining.add(gid)

    def drain_machine(self, machine: int) -> List[int]:
        """Drain every device of one machine and cordon it against new
        devices (a node going down for maintenance — the §7 kubernetes
        cordon-and-drain)."""
        self.cordoned.add(machine)
        gids = [g for g in self.machine_gpus(machine) if g not in self.failed]
        for gid in gids:
            self.drain_gpu(gid)
        return gids

    # -- mutation ----------------------------------------------------------------
    def apply(self, a: Action) -> int:
        """Apply one action; returns the uid of a created instance (or -1).

        Actions are atomic: an injected :class:`ActionFault` charges its
        wasted wall clock but leaves cluster state untouched."""
        for gid in a.gpus_touched():
            if gid in self.failed:
                raise ValueError(f"action {a.kind} targets failed gpu{gid}")
        mult = 1.0
        if self.fault_hook is not None:
            try:
                mult = self.fault_hook(a)
            except ActionFault as fault:
                self.clock += fault.wasted_s
                self._note_state()
                raise
        created = -1
        if a.kind == "create":
            g = self.gpus[a.gpu]
            new_part = tuple(sorted(g.partition() + (a.size,)))
            if not self.rules.is_legal_partition(new_part):
                raise ValueError(f"illegal create {a.size} on gpu{a.gpu} {g.partition()}")
            created = next(self._uid)
            g.instances[created] = InstanceRec(created, a.size, a.service, a.throughput)
            self.uid_gpu[created] = a.gpu
        elif a.kind == "delete":
            g = self.gpus[a.gpu]
            g.instances.pop(a.uid)
        elif a.kind == "migrate":
            g = self.gpus[a.gpu]
            rec = g.instances.pop(a.uid)
            dst = self.gpus[a.dst_gpu]
            new_part = tuple(sorted(dst.partition() + (rec.size,)))
            if not self.rules.is_legal_partition(new_part):
                raise ValueError(f"illegal migrate to gpu{a.dst_gpu}")
            created = next(self._uid)
            dst.instances[created] = dataclasses.replace(rec, uid=created)
            self.uid_gpu[created] = a.dst_gpu
        elif a.kind == "repartition":
            g = self.gpus[a.gpu]
            for uid in a.remove_uids:
                rec = g.instances[uid]
                if rec.service is not None:
                    raise ValueError("repartition may only touch idle instances")
                g.instances.pop(uid)
            for s in a.add_sizes:
                uid = next(self._uid)
                g.instances[uid] = InstanceRec(uid, s, None)
                self.uid_gpu[uid] = a.gpu
            if not self.rules.is_legal_partition(g.partition()):
                raise ValueError(f"illegal repartition on gpu{a.gpu}: {g.partition()}")
        else:
            raise ValueError(a.kind)
        seconds = a.seconds() * mult
        self.clock += seconds
        self.actions_applied.append(a)
        self.applied_seconds.append(seconds)
        self.trace.append((self.clock, self.throughput()))
        if self.record_instance_trace:
            self.instance_trace.append((self.clock, self.busy_instances()))
        return created


def parallel_makespan(
    actions: Sequence[Action],
    seconds: Optional[Sequence[float]] = None,
    max_concurrent: Optional[int] = None,
) -> float:
    """Dependency-aware makespan: actions conflict iff they touch a common
    GPU (§6 "actions can run in parallel if the affected GPUs are separate");
    order among conflicting actions follows the plan order (list scheduling).

    ``seconds`` overrides per-action durations (index-aligned with
    ``actions`` — how straggler-stretched charges flow back in);
    ``max_concurrent`` list-schedules over that many executor slots (the
    control plane's bounded concurrency), None meaning unbounded."""
    ready: Dict[int, float] = {}
    makespan = 0.0
    slots: Optional[List[float]] = (
        [0.0] * max_concurrent if max_concurrent else None
    )
    for i, a in enumerate(actions):
        dur = a.seconds() if seconds is None else seconds[i]
        start = max((ready.get(g, 0.0) for g in a.gpus_touched()), default=0.0)
        if slots is not None:
            j = min(range(len(slots)), key=slots.__getitem__)
            start = max(start, slots[j])
            slots[j] = start + dur
        end = start + dur
        for g in a.gpus_touched():
            ready[g] = end
        makespan = max(makespan, end)
    return makespan
