"""Port of `orientdb_tpu/parallel/` (the mesh): sharded adjacency
(`mesh_graph`), the row-sharded BFS and the mesh constructor (`sharded`),
over the shard groups of `collectives`."""
