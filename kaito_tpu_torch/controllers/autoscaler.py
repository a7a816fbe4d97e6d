"""Closed-loop autoscaler: ScalingSignal -> replicas -> warm capacity.

The actuation half of the autoscaling loop.  ``runtime/fleet.py`` is
the read side — per-CR ``ScalingSignal`` conditions and
``recommended_replicas`` hints; this controller is the consumer that
contract promised.  The reference KAITO delegates scaling to HPA/KEDA
via the scale subresource; a TPU-native operator owns the loop because
scale-up is gated on multi-minute slice boot (so capacity must be
provisioned AHEAD of the replica) and scale-down must not strand
in-flight decodes (so the victim drains THROUGH the EPP first).

One ``tick()`` per manager resync, after ``fleet.apply_signals()``,
actuating through three existing layers:

1. **Replicas** — sustained ``pressure|saturated`` raises
   ``spec.replicas`` toward the fleet's ``recommended_replicas``
   (bounded by ``autoscale.maxReplicas`` and ``nodeCountLimit``);
   sustained ``idle`` lowers it to ``minReplicas`` or zero.  The
   InferenceSetReconciler does the actual child create/delete.
2. **Warm TPU capacity** — the moment the signal enters ``pressure``
   the NEXT replica's NodePools are rendered through the provisioner
   (``provision/karpenter.py``), so replica boot is not serialized
   behind slice boot.  Warm pools whose replica never materialized are
   GC'd after the signal has stayed out of pressure for
   ``warmPoolGcS``.
3. **EPP drain** — scale-down first annotates the victim
   (``kaito-tpu.io/draining``); the set's EPP re-renders with
   ``--drain-backend`` (picker stops scoring it, in-flight requests
   finish) and only after ``drainGraceS`` does ``spec.replicas`` drop,
   letting the reconciler delete the drained victim first.

Scale-to-zero keeps the EPP front alive: arrivals keep ticking
``kaito:router_requests_received_total`` even with zero backends, and
a non-zero received rate wakes the set immediately (no stabilization —
the cold start is expensive enough already).

Per-direction stabilization windows + cooldowns + pending-drain
cancellation make signal oscillation cheap: a flap cancels the drain
and unmarks the victims instead of thrashing replicas.

Everything is observable — ``kaito:autoscaler_*`` gauges/counters on
the manager registry, ``ScalingUp/ScalingDown/ScaleToZero/
WarmPoolProvisioned/WarmPoolReclaimed`` Events, and an
``AutoscalerActive`` condition — and the whole subsystem sits behind
the ``autoscaler`` feature gate (off by default).

A copy of ``kaito_tpu.controllers.autoscaler``.  Warm pools are planned
by the port's ``plan_workspace`` and rendered by its provisioner, so a
GPU set's warm NodePool is the A3 one its next replica will take.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from kaito_tpu_torch.api.inferenceset import AutoscalePolicy, InferenceSet
from kaito_tpu_torch.api.meta import Condition, condition_true, get_condition, set_condition
from kaito_tpu_torch.api.workspace import (
    ANNOTATION_DRAINING,
    COND_INFERENCE_READY,
    LABEL_CREATED_BY_INFERENCESET,
    Workspace,
)
from kaito_tpu_torch.controllers.inferenceset import make_child_workspace
from kaito_tpu_torch.controllers.runtime import Store, update_with_retry
from kaito_tpu_torch.k8s.events import record_event
from kaito_tpu_torch.provision.karpenter import LABEL_OWNER
from kaito_tpu_torch.provision.provisioner import ProvisionRequest
from kaito_tpu_torch.runtime.fleet import (
    SIGNAL_IDLE,
    SIGNAL_PRESSURE,
    SIGNAL_SATURATED,
)

logger = logging.getLogger(__name__)

COND_AUTOSCALER_ACTIVE = "AutoscalerActive"
# warm pools carry this label until their replica materializes (then
# it is stripped — the pool is owned for real) or GC deletes them
LABEL_WARM_FOR = "kaito-tpu.io/warm-pool-for"

EVENT_SCALING_UP = "ScalingUp"
EVENT_SCALING_DOWN = "ScalingDown"
EVENT_SCALE_TO_ZERO = "ScaleToZero"
EVENT_WARM_PROVISIONED = "WarmPoolProvisioned"
EVENT_WARM_RECLAIMED = "WarmPoolReclaimed"

_UNBOUNDED = 1 << 30


@dataclass
class _SetState:
    """Per-InferenceSet actuation memory (in-process, rebuilt cheaply
    after a manager restart — worst case one extra stabilization
    window before the next action)."""

    last_scale_up_t: float = 0.0
    last_scale_down_t: float = 0.0
    # an initiated-but-uncommitted scale-down: victims are draining
    # through the EPP until the deadline, then spec.replicas drops
    pending_target: Optional[int] = None
    pending_deadline: float = 0.0
    pending_victims: list[str] = field(default_factory=list)
    # last-tick observability snapshot (metric gauges read these)
    desired: int = 0
    draining: int = 0
    warm_pools: int = 0
    phase: str = "Observing"


class AutoscalerController:
    """Not a per-object Reconciler: one ``tick()`` sweeps every
    InferenceSet whose ``spec.autoscale.enabled`` is set, reading the
    fleet plane's already-evaluated signals (the manager runs the tick
    right after ``fleet.apply_signals()``)."""

    kind = "InferenceSet"

    def __init__(self, store: Store, fleet, provisioner=None,
                 time_fn: Callable[[], float] = time.monotonic):
        from kaito_tpu_torch.engine.metrics import Counter

        self.store = store
        self.fleet = fleet
        self.provisioner = provisioner
        self.time_fn = time_fn
        self._state: dict[tuple, _SetState] = {}
        # registry-less until register_metrics; counting always works
        self.m_scale_events = Counter(
            "kaito:autoscaler_scale_events_total",
            "Committed scale actions (direction: up|down|zero|wake)",
            None, labels=("name", "direction"))

    # -- metrics -------------------------------------------------------

    def register_metrics(self, registry) -> None:
        from kaito_tpu_torch.engine.metrics import Gauge

        def per_set(attr):
            def _fn():
                return {(k[2],): float(getattr(st, attr))
                        for k, st in self._state.items()}
            return _fn

        Gauge("kaito:autoscaler_desired_replicas",
              "spec.replicas as last actuated/observed per InferenceSet",
              registry, labels=("name",), fn=per_set("desired"))
        Gauge("kaito:autoscaler_draining_replicas",
              "Victim replicas currently draining through the EPP",
              registry, labels=("name",), fn=per_set("draining"))
        Gauge("kaito:autoscaler_warm_pools",
              "Warm NodePools provisioned ahead of their replica",
              registry, labels=("name",), fn=per_set("warm_pools"))
        registry.register(self.m_scale_events)

    def _count_event(self, name: str, direction: str) -> None:
        self.m_scale_events.inc(name=name, direction=direction)

    # -- the loop ------------------------------------------------------

    def tick(self) -> None:
        live = set()
        for iset in self.store.list("InferenceSet"):
            key = ("InferenceSet", iset.metadata.namespace,
                   iset.metadata.name)
            live.add(key)
            try:
                self._reconcile_set(key, iset)
            except Exception:
                logger.exception("autoscaler pass failed for %s/%s",
                                 key[1], key[2])
        for key in list(self._state):
            if key not in live:
                del self._state[key]

    def _reconcile_set(self, key: tuple, iset: InferenceSet) -> None:
        pol: AutoscalePolicy = iset.spec.autoscale
        if not pol.enabled:
            self._state.pop(key, None)
            cur = get_condition(iset.status.conditions,
                                COND_AUTOSCALER_ACTIVE)
            if cur is not None and cur.status != "False":
                self._set_condition(iset, "False", "Disabled",
                                    "spec.autoscale.enabled is false")
            return
        pol.default()
        st = self._state.setdefault(key, _SetState())
        now = self.time_fn()
        ns, name = key[1], key[2]
        children = self._children(iset)
        cur = iset.spec.replicas
        st.desired = cur
        st.draining = len(st.pending_victims) if st.pending_target \
            is not None else 0
        st.warm_pools = len(self._warm_pools(iset))

        sig = self.fleet.signal(key)
        agg = self.fleet.last_aggregate(key)

        # -- scale-to-zero wake: first queued request at the EPP wins
        # over every window/cooldown (cold start costs enough already)
        if cur == 0 and agg.get("received_rate", 0.0) > 0.0:
            target = max(1, pol.min_replicas)
            self._write_replicas(iset, target)
            st.last_scale_up_t = now
            st.desired = target
            self._count_event(name, "wake")
            record_event(self.store, iset, "Normal", EVENT_SCALING_UP,
                         f"waking from zero to {target} replica(s): "
                         f"requests queued at the EPP")
            self._set_condition(iset, "True", "Waking",
                                "scale-from-zero on queued requests")
            st.phase = "Waking"
            return

        # -- minReplicas enforcement (a parked zero under scale-to-zero
        # is the one legal sub-minimum state)
        floor_now = max(1, pol.min_replicas)
        if cur < floor_now and not (pol.scale_to_zero and cur == 0):
            self._write_replicas(iset, floor_now)
            st.desired = floor_now
            self._count_event(name, "up")
            record_event(self.store, iset, "Normal", EVENT_SCALING_UP,
                         f"raising replicas to minReplicas={floor_now}")
            self._set_condition(iset, "True", "EnforcingMinimum",
                                f"spec.replicas below minReplicas "
                                f"{floor_now}")
            st.phase = "EnforcingMinimum"
            return

        if sig is None:
            self._set_condition(iset, "True", "Observing",
                                "no fleet telemetry evaluated yet")
            st.phase = "Observing"
            return
        state, since, decision = sig
        dwell = now - since

        if state in (SIGNAL_PRESSURE, SIGNAL_SATURATED):
            self._cancel_pending_down(iset, st, "signal left idle")
            # warm capacity the moment pressure is entered — replica
            # boot must not serialize behind slice boot
            self._ensure_warm(iset, pol, children)
            st.warm_pools = len(self._warm_pools(iset))
            cap = self._replica_cap(iset, pol, children)
            target = min(max(decision.recommended_replicas, cur + 1), cap)
            if target <= cur:
                self._set_condition(
                    iset, "True", "AtCapacity",
                    f"{state} sustained but replica cap {cap} reached")
                st.phase = "AtCapacity"
                return
            if dwell < pol.scale_up_stabilization_s:
                self._set_condition(
                    iset, "True", "Stabilizing",
                    f"{state} for {dwell:.0f}s of "
                    f"{pol.scale_up_stabilization_s:.0f}s stabilization")
                st.phase = "Stabilizing"
                return
            if now - st.last_scale_up_t < pol.scale_up_cooldown_s:
                self._set_condition(iset, "True", "CoolingDown",
                                    "scale-up cooldown in effect")
                st.phase = "CoolingDown"
                return
            self._write_replicas(iset, target)
            st.last_scale_up_t = now
            st.desired = target
            self._count_event(name, "up")
            record_event(self.store, iset, "Normal", EVENT_SCALING_UP,
                         f"sustained {state}: {cur} -> {target} "
                         f"replica(s) (recommended "
                         f"{decision.recommended_replicas})")
            self._set_condition(iset, "True", "ScalingUp",
                                f"scaling up to {target} on {state}")
            st.phase = "ScalingUp"
            return

        if state == SIGNAL_IDLE:
            self._maybe_gc_warm(iset, pol, dwell)
            target = pol.floor()
            if target >= cur:
                self._set_condition(iset, "True",
                                    "Idle" if cur else "ScaledToZero",
                                    f"idle at floor ({cur} replica(s))")
                st.phase = "Idle"
                return
            # commit an initiated drain once its grace elapsed
            if st.pending_target is not None:
                if now >= st.pending_deadline:
                    self._commit_scale_down(iset, st, name)
                else:
                    self._set_condition(
                        iset, "True", "Draining",
                        f"{len(st.pending_victims)} replica(s) draining "
                        f"through the EPP")
                    st.phase = "Draining"
                return
            need_dwell = max(pol.idle_grace_s,
                             pol.scale_down_stabilization_s)
            if dwell < need_dwell:
                self._set_condition(
                    iset, "True", "Stabilizing",
                    f"idle for {dwell:.0f}s of {need_dwell:.0f}s grace")
                st.phase = "Stabilizing"
                return
            if now - st.last_scale_down_t < pol.scale_down_cooldown_s:
                self._set_condition(iset, "True", "CoolingDown",
                                    "scale-down cooldown in effect")
                st.phase = "CoolingDown"
                return
            self._begin_scale_down(iset, st, children, target, now, pol)
            return

        # nominal: no actuation; flap suppression + warm GC
        self._cancel_pending_down(iset, st, "signal back to nominal")
        self._maybe_gc_warm(iset, pol, dwell)
        st.warm_pools = len(self._warm_pools(iset))
        self._set_condition(iset, "True", "Nominal",
                            "fleet inside the nominal band")
        st.phase = "Nominal"

    # -- scale-down drain ----------------------------------------------

    def _begin_scale_down(self, iset: InferenceSet, st: _SetState,
                          children: list[Workspace], target: int,
                          now: float, pol: AutoscalePolicy) -> None:
        victims = self._pick_victims(children, len(children) - target)
        for v in victims:
            self._mark_draining(v, True)
        st.pending_target = target
        st.pending_deadline = now + pol.drain_grace_s
        st.pending_victims = [v.metadata.name for v in victims]
        st.draining = len(victims)
        record_event(self.store, iset, "Normal", EVENT_SCALING_DOWN,
                     f"draining {len(victims)} replica(s) toward "
                     f"{target} ({pol.drain_grace_s:.0f}s EPP grace)")
        self._set_condition(iset, "True", "Draining",
                            f"{len(victims)} replica(s) draining "
                            f"through the EPP")
        st.phase = "Draining"

    def _commit_scale_down(self, iset: InferenceSet, st: _SetState,
                           name: str) -> None:
        target = st.pending_target or 0
        self._write_replicas(iset, target)
        st.last_scale_down_t = self.time_fn()
        st.desired = target
        st.pending_target = None
        st.pending_victims = []
        st.draining = 0
        if target == 0:
            self._count_event(name, "zero")
            record_event(self.store, iset, "Normal", EVENT_SCALE_TO_ZERO,
                         "sustained idle: parking the set at zero "
                         "replicas (EPP front stays up)")
            self._set_condition(iset, "True", "ScaledToZero",
                                "parked at zero replicas; EPP front "
                                "stays up for wake-on-arrival")
            st.phase = "ScaledToZero"
        else:
            self._count_event(name, "down")
            record_event(self.store, iset, "Normal", EVENT_SCALING_DOWN,
                         f"drain complete: replicas -> {target}")
            self._set_condition(iset, "True", "ScalingDown",
                                f"scaled down to {target}")
            st.phase = "ScalingDown"

    def _cancel_pending_down(self, iset: InferenceSet, st: _SetState,
                             why: str) -> None:
        """Flap suppression: a pending drain whose trigger vanished is
        cancelled — victims are unmarked, nothing thrashes."""
        if st.pending_target is None:
            return
        for ws_name in st.pending_victims:
            ws = self.store.try_get("Workspace", iset.metadata.namespace,
                                    ws_name)
            if ws is not None:
                self._mark_draining(ws, False)
        logger.info("autoscaler: cancelled pending scale-down of %s (%s)",
                    iset.metadata.name, why)
        st.pending_target = None
        st.pending_victims = []
        st.draining = 0

    def _pick_victims(self, children: list[Workspace],
                      count: int) -> list[Workspace]:
        """Not-ready replicas first (no traffic to drain), then the
        highest index (youngest, coldest caches)."""
        def order(ws):
            try:
                idx = int(ws.metadata.name.rsplit("-", 1)[1])
            except (IndexError, ValueError):
                idx = 0
            return (condition_true(ws.status.conditions,
                                   COND_INFERENCE_READY), -idx)
        return sorted(children, key=order)[: max(0, count)]

    def _mark_draining(self, ws: Workspace, flag: bool) -> None:
        def mutate(o):
            if flag:
                o.metadata.annotations[ANNOTATION_DRAINING] = "true"
            else:
                o.metadata.annotations.pop(ANNOTATION_DRAINING, None)
        try:
            update_with_retry(self.store, "Workspace",
                              ws.metadata.namespace, ws.metadata.name,
                              mutate)
        except Exception:
            logger.debug("drain mark failed for %s", ws.metadata.name,
                         exc_info=True)

    # -- warm pools ----------------------------------------------------

    def _ensure_warm(self, iset: InferenceSet, pol: AutoscalePolicy,
                     children: list[Workspace]) -> None:
        """Render the NodePools of the next ``warmPool`` replicas the
        moment pressure is entered, so the slices are booting while the
        stabilization window (and the Workspace create) still runs.
        The pools carry the real would-be replica names — when the
        Workspace materializes, the workspace reconciler's provision
        call finds them already there (and already warming)."""
        if self.provisioner is None or pol.warm_pool <= 0:
            return
        cap = self._replica_cap(iset, pol, children)
        used = {c.metadata.name for c in children}
        budget = max(0, min(pol.warm_pool, cap - len(children)))
        picked = []
        i = 0
        while len(picked) < budget:
            candidate = f"{iset.metadata.name}-{i}"
            i += 1
            if candidate not in used:
                picked.append((i - 1, candidate))
        for idx, owner in picked:
            try:
                ws = make_child_workspace(iset, idx)
                from kaito_tpu_torch.controllers.workspace import plan_workspace

                _, plan, slice_spec = plan_workspace(self.store, ws)
            except Exception:
                logger.debug("warm plan failed for %s", owner,
                             exc_info=True)
                continue
            req = ProvisionRequest(
                owner_name=owner, owner_namespace=iset.metadata.namespace,
                slice_spec=slice_spec,
                num_slices=plan.num_slices * ws.resource.count,
                extra_labels=dict(ws.resource.label_selector))
            missing = any(
                self.store.try_get("NodePool", "", f"{owner}-slice-{k}")
                is None for k in range(req.num_slices))
            self.provisioner.provision(req)
            self._label_warm(iset, owner)
            if missing:
                record_event(
                    self.store, iset, "Normal", EVENT_WARM_PROVISIONED,
                    f"provisioned warm NodePool(s) for next replica "
                    f"{owner} ({req.num_slices} slice(s), topology "
                    f"{slice_spec.topology})")

    def _label_warm(self, iset: InferenceSet, owner: str) -> None:
        for pool in self.store.list("NodePool",
                                    labels={LABEL_OWNER: owner}):
            if pool.metadata.labels.get(LABEL_WARM_FOR):
                continue

            def mutate(p):
                p.metadata.labels[LABEL_WARM_FOR] = iset.metadata.name
            try:
                update_with_retry(self.store, "NodePool", "",
                                  pool.metadata.name, mutate)
            except Exception:
                pass

    def _warm_pools(self, iset: InferenceSet) -> list:
        """Warm pools = labelled for this set AND their replica
        Workspace still absent.  Pools whose replica materialized are
        owned for real: the warm label is stripped."""
        out = []
        for pool in self.store.list(
                "NodePool", labels={LABEL_WARM_FOR: iset.metadata.name}):
            owner = pool.metadata.labels.get(LABEL_OWNER, "")
            if owner and self.store.try_get(
                    "Workspace", iset.metadata.namespace, owner) is not None:
                def mutate(p):
                    p.metadata.labels.pop(LABEL_WARM_FOR, None)
                try:
                    update_with_retry(self.store, "NodePool", "",
                                      pool.metadata.name, mutate)
                except Exception:
                    pass
                continue
            out.append(pool)
        return out

    def _maybe_gc_warm(self, iset: InferenceSet, pol: AutoscalePolicy,
                       dwell: float) -> None:
        """Sustained non-pressure reclaims warm pools whose replica
        never materialized (the pressure that provisioned them
        resolved without the scale-up committing)."""
        if dwell < pol.warm_pool_gc_s:
            return
        reclaimed = []
        for pool in self._warm_pools(iset):
            self.store.delete("NodePool", "", pool.metadata.name)
            reclaimed.append(pool.metadata.name)
        if reclaimed:
            record_event(self.store, iset, "Normal", EVENT_WARM_RECLAIMED,
                         f"reclaimed {len(reclaimed)} warm NodePool(s): "
                         f"{', '.join(sorted(reclaimed))}")

    # -- shared plumbing -----------------------------------------------

    def _children(self, iset: InferenceSet) -> list[Workspace]:
        return self.store.list(
            "Workspace", iset.metadata.namespace,
            labels={LABEL_CREATED_BY_INFERENCESET: iset.metadata.name})

    def _replica_cap(self, iset: InferenceSet, pol: AutoscalePolicy,
                     children: list[Workspace]) -> int:
        cap = pol.max_replicas or _UNBOUNDED
        if iset.spec.node_count_limit:
            per = self._nodes_per_replica(iset, children)
            cap = min(cap, iset.spec.node_count_limit // per)
        return cap

    def _nodes_per_replica(self, iset: InferenceSet,
                           children: list[Workspace]) -> int:
        observed = [c.status.target_node_count for c in children
                    if c.status.target_node_count > 0]
        if observed:
            return max(observed)
        try:
            from kaito_tpu_torch.controllers.workspace import plan_workspace

            ws = make_child_workspace(iset, 0)
            _, plan, _ = plan_workspace(self.store, ws)
            return max(1, plan.num_hosts * ws.resource.count)
        except Exception:
            return 1

    def _write_replicas(self, iset: InferenceSet, target: int) -> None:
        def mutate(o):
            o.spec.replicas = target
        update_with_retry(self.store, "InferenceSet",
                          iset.metadata.namespace, iset.metadata.name,
                          mutate)

    def _set_condition(self, iset: InferenceSet, status: str, reason: str,
                       message: str) -> None:
        """Write ``AutoscalerActive`` only on CHANGE (same zero-churn
        rule as the fleet plane's ScalingSignal writes)."""
        obj = self.store.try_get("InferenceSet", iset.metadata.namespace,
                                 iset.metadata.name)
        if obj is None:
            return
        cur = get_condition(obj.status.conditions, COND_AUTOSCALER_ACTIVE)
        if cur is not None and cur.status == status \
                and cur.reason == reason:
            return

        def mutate(o):
            set_condition(o.status.conditions, Condition(
                type=COND_AUTOSCALER_ACTIVE, status=status,
                reason=reason, message=message))
        try:
            update_with_retry(self.store, "InferenceSet",
                              iset.metadata.namespace, iset.metadata.name,
                              mutate)
        except Exception:
            logger.debug("AutoscalerActive write failed", exc_info=True)
