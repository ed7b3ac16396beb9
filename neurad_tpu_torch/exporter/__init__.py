"""Export utilities: TSDF fusion, Poisson reconstruction, mesh extraction, PLY writing."""
