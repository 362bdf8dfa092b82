"""Image helpers: PNG writing and reading without PIL, preview grids."""
