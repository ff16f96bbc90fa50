"""Stream sources and scaling (numpy), copied from the reference."""
