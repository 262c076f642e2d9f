"""Forward model: traveltime tables and receiver interpolation."""
