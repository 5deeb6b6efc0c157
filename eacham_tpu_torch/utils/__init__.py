"""numpy utilities: synthetic rendering and trajectory evaluation."""
