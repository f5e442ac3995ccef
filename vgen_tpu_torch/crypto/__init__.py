"""Trusted host-side cryptographic reference ("the oracle").

Pure-Python implementations of everything the device computes, used for:
  * known-answer conformance tests of every Pallas/JAX kernel,
  * decoding the handful of winning keys per scan on the host,
  * the `verify` CLI subcommand (the conformance oracle, reference
    lib.rs:377-494).

These run at Python speed (irrelevant: only winners flow through here).
"""
