"""Raft-lite leader election among control-plane replicas (paper §4).

Dirigent uses RAFT for CP leader election and collocates a Redis replica with
each CP replica (the Redis master follows the CP leader). We model the
timing-relevant subset: leader heartbeats, randomized election timeouts, a
single uncontested election round (vote RPCs), and the recovery procedure on
the new leader. The paper's C10 claim: detect + elect + fetch + DP-sync in
~10 ms.
"""
from __future__ import annotations

from typing import Generator, List, Optional, TYPE_CHECKING

from repro_torch.core.costmodel import DirigentCosts
from repro_torch.simcore import Environment

if TYPE_CHECKING:
    from repro_torch.core.control_plane import ControlPlane
    from repro_torch.core.cluster import Cluster


class LeaderElector:
    def __init__(self, env: Environment, cluster: "Cluster",
                 costs: DirigentCosts, enable_hb_sim: bool = True):
        self.env = env
        self.cluster = cluster
        self.costs = costs
        self.enable_hb_sim = enable_hb_sim
        self.term = 0
        self.leader_id: Optional[int] = None
        self._rng = env.rng("raft")
        self._monitor = None

    def bootstrap(self) -> None:
        """Initial election at cluster start (replica 0 wins)."""
        alive = self.cluster.control_planes_alive()
        if not alive:
            return
        self.term += 1
        leader = alive[0]
        self.leader_id = leader.cp_id
        leader.start_leader()
        if self.enable_hb_sim:
            self._monitor = self.env.process(self._monitor_loop(),
                                             name="raft-monitor")

    def _monitor_loop(self) -> Generator:
        """Followers' view: check leader liveness every heartbeat period."""
        c = self.costs
        while True:
            yield self.env.timeout(c.raft_heartbeat_period)
            leader = self.cluster.control_plane_by_id(self.leader_id)
            if leader is None or not leader.alive:
                # randomized election timeout, then a vote round
                yield self.env.timeout(
                    self._rng.uniform(0.5, 1.0) * c.raft_election_timeout)
                yield from self._elect()

    def _elect(self) -> Generator:
        alive = self.cluster.control_planes_alive()
        if not alive:
            self.leader_id = None
            return
        self.term += 1
        # one round of RequestVote RPCs among the survivors
        yield self.env.timeout(self.costs.raft_election_cost)
        new_leader = alive[0]
        self.leader_id = new_leader.cp_id
        self.cluster.collector.event(self.env.now, "leader-elected",
                                     new_leader.cp_id)
        yield from new_leader.recover_as_leader()
