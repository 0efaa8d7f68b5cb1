"""The distribution substrate of the port: fault tolerance
(``fault``: the step monitor, the checkpoint/restart supervisor and the
fleet's host supervisor) and the fleet's rung sharding
(``sharding.rung_shard``)."""
