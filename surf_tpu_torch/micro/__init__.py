"""Microbenchmarks of the card's mechanisms, each with a hand-written kernel:
``dep_chain`` (the walk's dependent cursor), ``leaf_groups`` and
``leaf_visit`` (the leaf rows), ``visit_cost``, ``quant_visit``,
``stack_visit`` and ``mask_reduce`` (the parts of a walk's visit), and
``visit_parts``, ``cond_visit`` and ``visit_bodies`` (the shape of a
visit: its loop, a branch between bodies, candidate bodies); shared
helpers in ``_visit``."""
