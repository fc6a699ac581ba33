"""Traffic drivers, one module a kind of mix; a mix names its driver."""
