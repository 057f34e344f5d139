"""Host syncs in one warm frame, counted in sync-debug mode (the sites are
printed on an earlier line of the run)."""


def read(trace):
    return float(len(trace.sync_sites))
