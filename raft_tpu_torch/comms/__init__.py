"""Top-k merging: the single-host merge core (the collectives wait for the
sharding slice)."""
