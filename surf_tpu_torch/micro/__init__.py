"""Microbenchmarks of the card's mechanisms, each with a hand-written kernel:
``dep_chain`` (the walk's dependent cursor), ``leaf_groups`` and
``leaf_visit`` (the leaf rows), and ``visit_cost``, ``quant_visit``,
``stack_visit`` and ``mask_reduce`` (the parts of a walk's visit; shared
helpers in ``_visit``)."""
