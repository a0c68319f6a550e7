"""Cost analysis of the port's steps (port of ``repro.analysis``): the
operation and byte count of a step (``op_cost``, in the role of the
reference's ``jaxpr_cost``), the collectives a sharded step runs
(``comm_cost``, in the role of ``hlo_collectives``), and the roofline over
the dry run's records (``roofline``)."""
