"""The port's multi-rank routes: the collectives (``comm``), Ulysses and
ring attention, USP, tensor parallelism, and K7's ring in one launch."""
