"""Host-side edge environment: fleet, mobility and workload (NumPy)."""
