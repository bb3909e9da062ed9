"""N-tier mesh topology: per-tier alpha/beta from nested rank groupings.

:class:`~accl_tpu_torch.tuner.cost.Topology` describes ONE fabric tier; a
production mesh is a NEST — chip / host / rack / pod — with roughly an
order of magnitude of beta lost per level. This module keeps
``Topology`` as the degenerate one-tier case and extends it with the
nest: ``groups`` is the INNERMOST grouping (ranks sharing the fastest
boundary, e.g. a host) priced by the ``inter_*`` fields, and ``outer``
is a tuple of :class:`TierSpec` entries adding coarser boundaries
(rack, pod, ...) innermost-first, each with its own link figures. A
mesh with no ``outer`` entries is exactly the two-tier shape every
pre-existing consumer (tuner cost models, ``recommend_segment_size``,
``Tuner._topo``'s ``dataclasses.replace``) was written against, so
every existing call site keeps working unchanged.

The grouping convention every hierarchical expansion relies on: ranks
of one group are CONTIGUOUS in world-rank order (group ids
non-decreasing along ranks), and every coarser grouping is a strict
coarsening of the one below it — each inner group lies wholly inside
one outer group. That is the production mapping (process launchers
number ranks host-major, racks enclose whole hosts), and it is what
makes a subtree's chunk a single contiguous byte range in
gather/scatter phases at every level of the nest.
"""

from __future__ import annotations

import dataclasses

from ..tuner.cost import Topology

__all__ = ["MeshTopology", "TierSpec", "groups_from_hosts",
           "validate_nest"]


def groups_from_hosts(hosts) -> tuple[tuple[int, ...], ...]:
    """Host groups (tuples of world ranks) from a rank->host-id list.

    Validates the contiguity convention (module docstring): a host's
    ranks must form one contiguous run. Host ids are opaque labels; only
    run boundaries matter.
    """
    hosts = list(hosts)
    if not hosts:
        raise ValueError("empty rank->host mapping")
    groups: list[list[int]] = []
    seen: set = set()
    cur = None
    for rank, h in enumerate(hosts):
        if h != cur:
            if h in seen:
                raise ValueError(
                    f"host {h!r} appears in two separate rank runs — "
                    f"hierarchical collectives require each host's ranks "
                    f"to be contiguous in world-rank order (got hosts="
                    f"{hosts})")
            seen.add(h)
            groups.append([])
            cur = h
        groups[-1].append(rank)
    return tuple(tuple(g) for g in groups)


def validate_nest(nest) -> None:
    """Check that ``nest`` (groupings innermost-first, each a tuple of
    rank tuples) is a strict contiguous coarsening chain: same world,
    every inner group wholly inside one outer group, strictly fewer
    groups per level going out (a level that splits nothing would add
    phases without moving bytes)."""
    nest = tuple(nest)
    for lvl in range(1, len(nest)):
        inner, outer = nest[lvl - 1], nest[lvl]
        if sum(len(g) for g in inner) != sum(len(g) for g in outer):
            raise ValueError(f"nest level {lvl} maps a different world "
                             f"than level {lvl - 1}")
        if len(outer) >= len(inner):
            raise ValueError(
                f"nest level {lvl} has {len(outer)} groups, not coarser "
                f"than level {lvl - 1}'s {len(inner)} — each tier must "
                f"merge groups of the one below")
        owner = {}
        for gi, g in enumerate(outer):
            for r in g:
                owner[r] = gi
        for g in inner:
            if len({owner[r] for r in g}) != 1:
                raise ValueError(
                    f"nest level {lvl} splits inner group {g} across "
                    f"outer groups — coarser tiers must enclose whole "
                    f"inner groups")


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """One coarser boundary of the nest: a rank->group-id mapping (same
    contiguity convention as ``hosts``) plus the link figures of frames
    CROSSING that boundary."""

    hosts: tuple = ()
    alpha_us: float = 1000.0
    beta_gbps: float = 0.02
    incast: float = 2.0

    def groups(self) -> tuple[tuple[int, ...], ...]:
        return groups_from_hosts(self.hosts)


@dataclasses.dataclass(frozen=True)
class MeshTopology(Topology):
    """Nested-tier link descriptor.

    The INHERITED fields (``alpha_us``, ``beta_gbps``, ``incast``,
    ``pipeline_depth``, ``supported``) describe the fast INTRA-group
    tier; the ``inter_*`` fields describe the first slow boundary (the
    innermost grouping ``groups`` — contiguous world ranks per host,
    :func:`groups_from_hosts`); ``outer`` optionally adds coarser
    boundaries (rack, pod, ...) innermost-first as :class:`TierSpec`
    entries. With one group (or none) everything degenerates to the
    base one-tier ``Topology`` semantics and the hierarchical cost
    models price themselves out (infinite); with ``outer == ()`` the
    mesh is exactly the historical two-tier shape.
    """

    groups: tuple[tuple[int, ...], ...] = ()
    inter_alpha_us: float = 500.0   # per-hop latency on the slow tier
    inter_beta_gbps: float = 0.1    # per-link bandwidth on the slow tier
    inter_incast: float = 2.0       # fan-in congestion at a hot host NIC
    outer: tuple = ()               # coarser TierSpec boundaries, in->out

    def __post_init__(self):
        if self.outer and self.groups:
            validate_nest((self.groups,)
                          + tuple(s.groups() for s in self.outer))

    @classmethod
    def from_hosts(cls, hosts, *, alpha_us: float = 50.0,
                   beta_gbps: float = 1.0,
                   inter_alpha_us: float = 500.0,
                   inter_beta_gbps: float = 0.1,
                   tier: str = "two-tier", **kw) -> "MeshTopology":
        """Build from a rank->host-id list (the usual entry point)."""
        groups = groups_from_hosts(hosts)
        return cls(world_size=len(list(hosts)), alpha_us=alpha_us,
                   beta_gbps=beta_gbps, tier=tier, groups=groups,
                   inter_alpha_us=inter_alpha_us,
                   inter_beta_gbps=inter_beta_gbps, **kw)

    @classmethod
    def from_nest(cls, tiers, *, alpha_us: float = 50.0,
                  beta_gbps: float = 1.0, tier: str = "n-tier",
                  **kw) -> "MeshTopology":
        """Build from boundary descriptions innermost-first: ``tiers``
        is a sequence of ``(hosts_map, alpha_us, beta_gbps)`` triples,
        one per boundary — ``tiers[0]`` is the host boundary (the
        historical ``inter_*`` figures), later entries add rack/pod
        levels. The inherited ``alpha_us``/``beta_gbps`` keep pricing
        the intra tier."""
        tiers = list(tiers)
        if not tiers:
            raise ValueError("from_nest needs at least one boundary tier")
        h0, a0, b0 = tiers[0]
        specs = tuple(TierSpec(hosts=tuple(h), alpha_us=float(a),
                               beta_gbps=float(b))
                      for h, a, b in tiers[1:])
        return cls.from_hosts(h0, alpha_us=alpha_us, beta_gbps=beta_gbps,
                              inter_alpha_us=float(a0),
                              inter_beta_gbps=float(b0),
                              tier=tier, outer=specs, **kw)

    # -- structure ---------------------------------------------------------
    @property
    def n_hosts(self) -> int:
        return len(self.groups)

    @property
    def two_tier(self) -> bool:
        """More than one host => the inter tier actually exists."""
        return self.n_hosts > 1

    @property
    def n_tiers(self) -> int:
        """Number of link tiers: 1 (flat) or 2 + coarser boundaries."""
        return 1 if not self.two_tier else 2 + len(self.outer)

    @property
    def aligned(self) -> bool:
        """All hosts hold the same number of ranks (the index-aligned
        outer-communicator decomposition applies)."""
        sizes = {len(g) for g in self.groups}
        return len(sizes) == 1

    @property
    def mesh_world(self) -> int:
        return sum(len(g) for g in self.groups)

    def hosts_list(self) -> list[int]:
        """rank -> host index (inverse of ``groups``)."""
        out = [0] * self.mesh_world
        for h, g in enumerate(self.groups):
            for r in g:
                out[r] = h
        return out

    def nest(self) -> tuple[tuple[tuple[int, ...], ...], ...]:
        """All groupings innermost-first — the shape the recursive
        planner (:func:`accl_tpu_torch.hier.plan_phases`) consumes."""
        return (self.groups,) + tuple(s.groups() for s in self.outer)

    def hosts_levels(self) -> list[list[int]]:
        """Per-boundary rank->group-id maps innermost-first (the
        ``configure_hierarchy(hosts, levels=...)`` form)."""
        return [self.hosts_list()] + [list(s.hosts) for s in self.outer]

    # -- per-tier views (what the phase cost models price against) ---------
    def intra_topology(self, world_size: int | None = None) -> Topology:
        """The fast tier as a flat one-tier Topology."""
        return Topology(world_size=(world_size if world_size is not None
                                    else max(len(g) for g in self.groups)),
                        alpha_us=self.alpha_us, beta_gbps=self.beta_gbps,
                        incast=self.incast, tier=f"{self.tier}/intra",
                        pipeline_depth=self.pipeline_depth,
                        supported=self.supported)

    def inter_topology(self, world_size: int | None = None) -> Topology:
        """The slow tier as a flat one-tier Topology (one endpoint per
        host — leaders, or the index-aligned outer groups)."""
        return Topology(world_size=(world_size if world_size is not None
                                    else self.n_hosts),
                        alpha_us=self.inter_alpha_us,
                        beta_gbps=self.inter_beta_gbps,
                        incast=self.inter_incast,
                        tier=f"{self.tier}/inter",
                        pipeline_depth=self.pipeline_depth,
                        supported=self.supported)

    def tier_topology(self, level: int,
                      world_size: int | None = None) -> Topology:
        """Tier ``level`` as a flat one-tier Topology: 0 = intra, 1 =
        the host boundary (``inter_*``), ``k >= 2`` = ``outer[k - 2]``.
        The recursive planner prices each phase against the topology of
        the slowest tier that phase's members span."""
        if level <= 0:
            return self.intra_topology(world_size)
        if level == 1:
            return self.inter_topology(world_size)
        spec = self.outer[level - 2]
        w = world_size if world_size is not None else len(spec.groups())
        return Topology(world_size=w, alpha_us=spec.alpha_us,
                        beta_gbps=spec.beta_gbps, incast=spec.incast,
                        tier=f"{self.tier}/tier{level}",
                        pipeline_depth=self.pipeline_depth,
                        supported=self.supported)

    def tier_beta_gbps(self, level: int) -> float:
        """Per-link bandwidth of tier ``level`` (the per-tier quantize
        predicate's input)."""
        if level <= 0:
            return self.beta_gbps
        if level == 1:
            return self.inter_beta_gbps
        return self.outer[level - 2].beta_gbps

    def flat_equivalent(self) -> Topology:
        """What a FLAT (tier-blind) algorithm effectively sees on this
        mesh: ring-schedule weighted link figures. Of a full ring's W
        hops, each boundary tier claims one hop per contiguous group
        run (wrapping) MINUS the hops already claimed by coarser tiers
        — with G_k groups at level k, tier k crosses ``G_{k-1} - G_k``
        hops (``G_{-1} = W``, the outermost tier keeps all its
        boundary hops). Alpha mixes linearly by hop fraction and beta
        mixes harmonically (per-byte times add). Only the ORDERING
        against the hierarchical models needs to be right — measurement
        refines the rest (tuner.py).
        """
        if not self.two_tier:
            return self.intra_topology(self.world_size or self.mesh_world)
        w = self.mesh_world
        nest = self.nest()
        counts = [len(g) for g in nest]          # groups per level, in->out
        # hops crossing tier k (1-based over boundaries): boundaries of
        # level k-1's grouping not shared with a coarser boundary
        hops = []
        prev = w
        for c in counts:
            hops.append(prev - c)
            prev = c
        hops.append(prev)                        # outermost boundary hops
        alphas = ([self.alpha_us, self.inter_alpha_us]
                  + [s.alpha_us for s in self.outer])
        betas = ([self.beta_gbps, self.inter_beta_gbps]
                 + [s.beta_gbps for s in self.outer])
        incasts = ([self.incast, self.inter_incast]
                   + [s.incast for s in self.outer])
        alpha = sum(h / w * a for h, a in zip(hops, alphas))
        inv_beta = sum(h / w / b for h, b in zip(hops, betas))
        return Topology(world_size=self.world_size or w, alpha_us=alpha,
                        beta_gbps=1.0 / inv_beta,
                        incast=max(incasts),
                        tier=f"{self.tier}/flat-equivalent",
                        pipeline_depth=self.pipeline_depth,
                        supported=self.supported)
