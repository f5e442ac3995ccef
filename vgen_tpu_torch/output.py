"""Result output writers: text / json / jsonl / csv / minimal (+ --file).

Parity with the reference's output block (lib.rs:879-976), including RFC
4180 CSV escaping (lib.rs:1058-1073) and the VanityResult field set
(lib.rs:244-254).
"""

from __future__ import annotations

import json
import sys
from dataclasses import asdict, dataclass
from typing import IO, List, Optional


@dataclass
class VanityResult:
    address: str
    wif: str
    private_key_hex: str
    format: str
    pattern: str
    operations: int
    elapsed_secs: float
    rate: float


def csv_escape(field: str) -> str:
    if any(c in field for c in ",\"\n\r"):
        return '"' + field.replace('"', '""') + '"'
    return field


def format_duration(secs: float) -> str:
    """lib.rs:1038-1052 parity."""
    if secs < 1.0:
        return f"{secs * 1000.0:.0f}ms"
    if secs < 60.0:
        return f"{secs:.1f}s"
    if secs < 3600.0:
        return f"{secs / 60.0:.1f}m"
    if secs < 86400.0:
        return f"{secs / 3600.0:.1f}h"
    if secs < 31536000.0:
        return f"{secs / 86400.0:.1f}d"
    return f"{secs / 31536000.0:.1f}y"


def format_with_commas(n: int) -> str:
    return f"{n:,}"


def write_results(
    results: List[VanityResult],
    output: str,
    writer: IO[str],
    quiet: bool = False,
) -> None:
    if output == "csv" and results:
        writer.write(
            "address,wif,private_key_hex,format,pattern,operations,elapsed_secs,rate\n"
        )
    for idx, r in enumerate(results):
        if output == "text":
            writer.write(f"=== Match {idx + 1} of {len(results)} ===\n")
            writer.write(f"Pattern : {r.pattern}\n")
            writer.write(f"Format  : {r.format}\n")
            writer.write(f"Address : {r.address}\n")
            writer.write(f"WIF     : {r.wif}\n")
            writer.write(f"Hex     : {r.private_key_hex}\n")
            if not quiet:
                writer.write(
                    f"Ops     : {format_with_commas(r.operations)} ({r.rate:.0f}/sec)\n"
                )
                writer.write(f"Time    : {format_duration(r.elapsed_secs)}\n")
            writer.write("\n")
        elif output == "json":
            writer.write(json.dumps(asdict(r), indent=2) + "\n")
        elif output == "jsonl":
            writer.write(json.dumps(asdict(r)) + "\n")
        elif output == "csv":
            writer.write(
                ",".join(
                    [
                        csv_escape(r.address),
                        csv_escape(r.wif),
                        csv_escape(r.private_key_hex),
                        csv_escape(r.format),
                        csv_escape(r.pattern),
                        str(r.operations),
                        str(r.elapsed_secs),
                        str(r.rate),
                    ]
                )
                + "\n"
            )
        elif output == "minimal":
            writer.write(r.wif + "\n")
        else:  # pragma: no cover
            raise ValueError(f"unknown output format {output}")
