# Build/test harness (analogue of the reference's Makefile/Makefile.common)

PYTHON ?= python

.PHONY: all test test-fast native workflow bench chip-smoke cli-docs clean

all: native test

native: native/libsloika_native.so

native/libsloika_native.so: native/sloika_native.cpp
	g++ -O3 -shared -fPIC -std=c++17 $< -o $@

# -n 4: process-parallel like the reference's `py.test -n 4`
# (Makefile.common:29-37); each worker gets its own virtual 8-device mesh
test: native
	JAX_PLATFORMS=cpu $(PYTHON) -m pytest tests/ -q -n 4

test-fast: native
	JAX_PLATFORMS=cpu $(PYTHON) -m pytest tests/ -q -n 4 -m "not slow"

# End-to-end workflow on simulated reads (chunkify -> train -> validate ->
# basecall -> evaluate -> remap); the reference's `make workflow`
workflow: native
	bash scripts/workflow.sh

bench:
	$(PYTHON) bench.py

# the main paths on the GPU, with kernel parity (needs a card)
chip-smoke:
	$(PYTHON) chip_smoke.py

cli-docs:
	JAX_PLATFORMS=cpu PYTHONPATH=.:$$PYTHONPATH \
	  $(PYTHON) scripts/gen_cli_docs.py > docs/CLI.md

clean:
	rm -f native/libsloika_native.so
	find . -name __pycache__ -type d -exec rm -rf {} +
