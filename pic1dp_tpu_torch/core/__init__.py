"""Core: state, loading, the RK2 step, diagnostics, the driver."""
