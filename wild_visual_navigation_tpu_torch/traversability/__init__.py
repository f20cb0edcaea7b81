"""The online learning engine: nodes, graphs, the mission buffer and the estimator."""
