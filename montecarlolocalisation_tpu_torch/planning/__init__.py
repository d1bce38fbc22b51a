"""Planning and mission: BFS wall-graph paths, Held-Karp TSP, plan
execution."""
