"""Process-grid meshes and exchange strategies."""
