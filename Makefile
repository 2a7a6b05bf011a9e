# Convenience driver — UX parity with the reference Makefile targets
# (reference Makefile:84-173: test / test-mpi / test-correctness /
# run-benchmark / generate-data / charts / clean / help), adapted to the
# JAX framework. All real logic lives in the Python package.

PY ?= python

.PHONY: test test-gpu test-correctness test-parallel test-distributed bench bench-all data charts clean help weak-scaling bench-full

test:
	$(PY) -m pytest tests/ -q

# Tests that need the card (marker `gpu`); they skip without one.
test-gpu:
	SA_TEST_PLATFORM=gpu $(PY) -m pytest tests/test_gpu.py -q -m gpu

# Golden LRS answers (reference Makefile:131-138): banana->ana,
# mississippi->issi, abcabcabc->abcabc.
test-correctness:
	$(PY) -m hpc_suffix_array_tpu.cli banana | grep -q "'ana' (length: 3)"
	$(PY) -m hpc_suffix_array_tpu.cli mississippi | grep -q "'issi' (length: 4)"
	$(PY) -m hpc_suffix_array_tpu.cli abcabcabc | grep -q "'abcabc' (length: 6)"
	@echo "golden correctness: OK"

# Multi-device analog of `make test-mpi` (reference Makefile:126-128).
test-parallel:
	JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
	  $(PY) -m pytest tests/test_parallel.py -q

# REAL multi-process run: 2 CPU workers over jax.distributed on the
# banana fixture — the exact launch shape of the reference's
# `make test-mpi` (mpirun -np 4 ./bin/main_mpi test_data/banana.txt).
test-distributed: data
	SA_PLATFORM=cpu $(PY) -m hpc_suffix_array_tpu.cli test_data/banana.txt --spawn 2 \
	  | grep -q "MPI_PROCESSES:2"
	@echo "distributed CLI: OK"

bench:
	$(PY) bench.py

bench-all:
	$(PY) -m hpc_suffix_array_tpu.bench.orchestrator --quick

data:
	$(PY) -c "from hpc_suffix_array_tpu.datasets import *; \
	  generate_test_fixtures('test_data'); \
	  generate_standard_datasets('test_data', random_mb=(1,), repetitive_mb=(1,), dna_mb=(10,))"

charts:
	$(PY) -c "from hpc_suffix_array_tpu.viz import *; \
	  generate_comparative_charts(); generate_multi_backend_report(); \
	  generate_phase_breakdown_chart('results/benchmarks/sequential_results.csv')"

clean:
	rm -rf results __pycache__ **/__pycache__ .pytest_cache
	rm -f hpc_suffix_array_tpu/native/_native_*.so

help:
	@echo "targets: test test-gpu test-correctness test-parallel test-distributed bench bench-all data charts clean"

# Weak-scaling proxy sweep on the virtual CPU mesh (writes evidence
# under results/weak_scaling/ — see BASELINE.md for the metric).
weak-scaling:
	python -m hpc_suffix_array_tpu.bench.weak_scaling

# Full pipeline at reference scale (datasets -> sweeps -> charts ->
# reports; reference run_all_benchmarks.py:46-88 + the 500 MB point).
bench-full:
	python -m hpc_suffix_array_tpu.bench.orchestrator --random-mb 1 50 100 500
