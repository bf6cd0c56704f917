"""The benchmark's own counts: operations from the configuration's shapes,
bytes a kernel must move, and the card's published peaks."""
