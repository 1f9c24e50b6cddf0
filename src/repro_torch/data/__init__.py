"""Data generation for the port (synthetic TPC-H lineitem)."""
