from . import diff, pallas_lqr, scan_lqr, types  # noqa: F401
