"""Runtime substrate: training supervisor with fault tolerance."""
