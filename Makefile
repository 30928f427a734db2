# Convenience targets. The package itself needs no build step; `native`
# compiles the optional C++ bit-packing library (also built on first use by
# fractencode_tpu/codec/native.py whenever the source's hash changes).

.PHONY: all native test test-gpu smoke bench clean

all: native

native: native/_bitpack.so

native/_bitpack.so: native/bitpack.cpp
	g++ -O2 -shared -fPIC -std=c++17 -o $@ $<

test:
	python -m pytest tests/ -q

test-gpu:
	JAX_PLATFORMS=cuda python -m pytest tests/ -q -m gpu

smoke:
	python chip_smoke.py

bench:
	python bench.py

clean:
	rm -f native/_bitpack.so native/_bitpack.sha256
