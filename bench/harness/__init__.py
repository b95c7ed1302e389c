"""The benchmark's general code: it finds a cell's files by the names in
`BENCHMARK.json`, makes the cell's inputs and weights from the seed, drives
the program under test (the port, `repro_torch`) through the cell's traffic,
reads the metrics, and compares what the timed path produced with the plain
reference under `bench/reference/`."""
