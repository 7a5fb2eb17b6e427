"""Best-effort topology-aware allocation policy.

The port's counterpart of the JAX package's ``allocator/besteffort.py``:
the same validation, the same fill and greedy candidates, the same
selection key and ordering, with one change of search:

1. **NVLink clique pass** — when one NVLink clique (a set of GPUs joined
   by NVLink, directly or through NVSwitches) holds the request and all
   its required devices, only subsets inside a clique are candidates:
   there the collectives run over NVLink, whatever PCIe would score.
   This replaces the reference's contiguous ICI sub-mesh pass.
2. **Anti-fragmentation fill** and 3. **greedy multi-seed growth** by
   least added pairwise weight, over every available device, when no
   clique can hold the request.

The lowest total pairwise weight wins; ties go to fewer distinct GPUs,
then the lowest indices.  On a node without NVLink the search is the
reference's with its PCIe/NUMA weights, and picks what it picks.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from ..gpu.topology import GpuTopology
from .allocator import AllocationError, Policy
from .device import AllocDevice, WeightModel, group_by_parent


class BestEffortPolicy(Policy):
    def __init__(self) -> None:
        self._model: Optional[WeightModel] = None
        self._groups: Dict[str, List[AllocDevice]] = {}
        self._cliques: List[frozenset] = []

    def init(
        self,
        devices: Sequence[AllocDevice],
        topology: Optional[GpuTopology] = None,
    ) -> None:
        if not devices:
            raise AllocationError("no devices to initialise policy with")
        ids = [d.id for d in devices]
        if len(set(ids)) != len(ids):
            raise AllocationError("duplicate device ids")
        self._model = WeightModel(devices, topology)
        # parent grouping and cliques are static after init; only the
        # availability-dependent counts are derived per call
        self._groups = group_by_parent(devices)
        self._cliques = []
        if topology is not None:
            for members in topology.cliques:
                clique = frozenset(d.id for d in devices
                                   if d.parent_id in members)
                if len(clique) >= 2:
                    self._cliques.append(clique)

    # -- validation (the reference's, case for case) -------------------------
    def allocate(
        self,
        available_ids: Sequence[str],
        required_ids: Sequence[str],
        size: int,
    ) -> List[str]:
        if self._model is None:
            raise AllocationError("policy not initialised")
        if size <= 0:
            raise AllocationError("allocation size must be a positive integer")
        if len(available_ids) < size:
            raise AllocationError(
                f"allocation size {size} exceeds {len(available_ids)} available"
            )
        if len(required_ids) > size:
            raise AllocationError("more required devices than allocation size")
        model = self._model
        unknown = [i for i in list(available_ids) + list(required_ids)
                   if i not in model.by_id]
        if unknown:
            raise AllocationError(f"unknown device ids: {unknown}")
        if not set(required_ids) <= set(available_ids):
            raise AllocationError("required devices not all available")
        if len(available_ids) == size:
            return self._ordered(available_ids)
        if len(required_ids) == size:
            return self._ordered(required_ids)

        available = frozenset(available_ids)
        required = frozenset(required_ids)
        free_count = {
            p: sum(1 for d in devs if d.id in available)
            for p, devs in self._groups.items()
        }

        # one NVLink clique takes strict priority: a PCIe pair may score
        # close, but only NVLink carries the workload's collectives
        candidates = self._clique_candidates(size, available, required,
                                             free_count)
        if not candidates:
            candidates = self._fill_candidates(size, available, required)
            candidates.extend(
                self._greedy_candidates(size, available, required,
                                        free_count))
        if not candidates:
            raise AllocationError("no candidate subsets found")

        best = min(candidates, key=lambda c: self._candidate_key(c, free_count))
        return self._ordered([d.id for d in best])

    # -- candidate generators -----------------------------------------------

    def _clique_candidates(self, size, available, required, free_count):
        out = []
        for clique in self._cliques:
            pool = available & clique
            if len(pool) >= size and required <= clique:
                out.extend(self._greedy_candidates(size, pool, required,
                                                   free_count))
        return out

    def _fill_candidates(self, size, available, required):
        """Satisfy from as few GPUs as possible, filling the least-free
        first (anti-fragmentation)."""
        model = self._model
        req_devs = [model.by_id[i] for i in required]
        req_parents = {d.parent_id for d in req_devs}

        free = []
        for parent, devs in self._groups.items():
            f = [d for d in devs if d.id in available and d.id not in required]
            if f:
                free.append((parent, f))
        # fewest free first; required GPUs' leftovers before untouched
        # ones; parent id as the final deterministic tie-break
        free.sort(key=lambda pf: (pf[0] not in req_parents, len(pf[1]), pf[0]))

        chosen = list(req_devs)
        for _parent, devs in free:
            for d in devs:
                if len(chosen) == size:
                    break
                chosen.append(d)
            if len(chosen) == size:
                break
        return [chosen] if len(chosen) == size else []

    def _greedy_candidates(self, size, available, required, free_count):
        model = self._model
        req_devs = [model.by_id[i] for i in required]
        pool = [model.by_id[i] for i in sorted(
            available, key=lambda i: model.by_id[i].sort_key)
            if i not in required]

        def grow(seed: List[AllocDevice]) -> Optional[List[AllocDevice]]:
            chosen = list(seed)
            chosen_ids = {d.id for d in chosen}
            while len(chosen) < size:
                best_d, best_key = None, None
                for d in pool:
                    if d.id in chosen_ids:
                        continue
                    delta = sum(model.weight(d.id, c.id) for c in chosen)
                    key = (delta, free_count[d.parent_id], d.sort_key)
                    if best_key is None or key < best_key:
                        best_d, best_key = d, key
                if best_d is None:
                    return None
                chosen.append(best_d)
                chosen_ids.add(best_d.id)
            return chosen

        out = []
        if req_devs:
            grown = grow(req_devs)
            if grown:
                out.append(grown)
        else:
            for seed in pool:
                grown = grow([seed])
                if grown:
                    out.append(grown)
        return out

    # -- selection -----------------------------------------------------------

    def _candidate_key(self, devs: List[AllocDevice], free_count):
        ids = [d.id for d in devs]
        parents = {d.parent_id for d in devs}
        return (
            self._model.set_weight(ids),
            len(parents),
            # hole-filling: prefer GPUs with fewer free devices left
            sum(free_count.get(p, 0) for p in parents),
            sorted(d.sort_key for d in devs),
        )

    def _ordered(self, ids) -> List[str]:
        model = self._model
        return sorted(ids, key=lambda i: model.by_id[i].sort_key)
