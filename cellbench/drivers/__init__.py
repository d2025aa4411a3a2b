"""One driver a kind of traffic, found by the name a workload gives."""
