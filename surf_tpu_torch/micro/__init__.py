"""Microbenchmarks of the card's mechanisms, each with a hand-written kernel:
``dep_chain`` (the walk's dependent cursor), ``leaf_groups`` and
``leaf_visit`` (the leaf rows), ``visit_cost``, ``quant_visit``,
``stack_visit`` and ``mask_reduce`` (the parts of a walk's visit),
``visit_parts``, ``cond_visit`` and ``visit_bodies`` (the shape of a
visit: its loop, a branch between bodies, candidate bodies),
``mxu_tiles``, ``mxu_parts`` and ``mxu_pltd`` (the leaf test as a
tensor-core product), and ``lane_splat``, ``lane_extract``,
``walk_interleave`` and ``spec_visit`` (what one operation of a visit
costs: handing a row's lane to every thread, reading lanes against
vector ops, walks interleaved under one vote, W rows a visit); shared
helpers in ``_visit`` and ``_mxu``."""
