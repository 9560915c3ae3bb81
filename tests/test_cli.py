"""CLI parity tests: flag parsing, default names, round-trip through files,
error paths, debug output, size summary."""

import subprocess
import sys
from pathlib import Path

import pytest

from entreepy_tpu.cli import CliError, default_output_name, main, parse_args
from entreepy_tpu.format import compress_host
from entreepy_tpu.utils.fmt import format_file_size

REPO = Path(__file__).parent.parent


def run_cli(args, cwd):
    return subprocess.run(
        [sys.executable, "-m", "entreepy_tpu", *args],
        capture_output=True,
        text=False,
        cwd=str(cwd),
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO), "HOME": "/root",
             "JAX_PLATFORMS": "cpu"},
    )


# --- pure parsing (fast) ---


def test_parse_cluster_flags():
    o = parse_args(["-ptd", "c", "in.txt", "-o", "out.et"])
    assert (o.print_output, o.debug, o.dry) == (True, True, True)
    assert o.mode == "compress" and o.file_in == "in.txt" and o.file_out == "out.et"


def test_parse_long_flags():
    o = parse_args(["--test", "--debug", "d", "x.et", "--output", "y.txt"])
    assert o.dry and o.debug and o.mode == "decompress"
    assert o.file_in == "x.et" and o.file_out == "y.txt"


def test_parse_errors():
    with pytest.raises(CliError, match="invalid option"):
        parse_args(["-z", "c", "f"])
    with pytest.raises(CliError, match="invalid option"):
        parse_args(["--bogus"])
    with pytest.raises(CliError, match="invalid command"):
        parse_args(["compress", "f"])
    with pytest.raises(CliError, match="no input file"):
        parse_args(["c"])


def test_default_output_names():
    assert default_output_name("compress", "a/b/text.txt") == "a/b/text.txt.et"
    assert default_output_name("decompress", "a/b/text.txt.et") == "a/b/decoded_text.txt"
    assert default_output_name("decompress", "text.et") == "decoded_text"
    assert default_output_name("decompress", "noext") == "decoded_noext"


def test_help_on_no_args(capsys):
    assert main([]) == 0
    out = capsys.readouterr().out
    assert "Usage: entreepy" in out and "-o, --output" in out


def test_format_file_size():
    assert format_file_size(477) == "477 B"
    assert format_file_size(66312) == "64.76 KB"
    assert format_file_size(5 * 1024 * 1024) == "5.00 MB"
    assert format_file_size(3 * 1024**3) == "3.00 GB"


# --- end-to-end through the real process ---


def test_cli_roundtrip_files(tmp_path, macbeth):
    src = tmp_path / "play.txt"
    src.write_bytes(macbeth)
    r = run_cli(["c", str(src)], tmp_path)
    assert r.returncode == 0, r.stderr
    et = tmp_path / "play.txt.et"
    assert et.read_bytes() == compress_host(macbeth)
    assert b"=> 374 B" in r.stderr

    r = run_cli(["d", str(et)], tmp_path)
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "decoded_play.txt").read_bytes() == macbeth


def test_cli_print_and_dry(tmp_path, macbeth):
    src = tmp_path / "p.txt"
    src.write_bytes(macbeth)
    (tmp_path / "p.txt.et").write_bytes(compress_host(macbeth))
    r = run_cli(["-pt", "d", str(tmp_path / "p.txt.et")], tmp_path)
    assert r.returncode == 0, r.stderr
    assert r.stdout == macbeth  # -p prints decoded text
    assert not (tmp_path / "decoded_p.txt").exists()  # -t wrote nothing


def test_cli_debug_output(tmp_path, tiny_text):
    src = tmp_path / "t.txt"
    src.write_bytes(tiny_text)
    r = run_cli(["-td", "c", str(src)], tmp_path)
    assert r.returncode == 0, r.stderr
    out = r.stdout.decode()
    assert "time taken:" in out and "bits in output:" in out
    assert " - " in out  # dictionary lines


def test_cli_help_text_reference_bytes(tmp_path):
    """The help text opens with a byte-exact copy of the reference's
    (``main.zig:45-67``); accelerator additions follow in a separate section."""
    from entreepy_tpu.cli import HELP_TEXT, REFERENCE_HELP_TEXT

    expected = (
        "Entreepy - Text compression tool\n"
        "\n"
        "Usage: entreepy [options] [command] [file] [command options]\n"
        "\n"
        "Options:\n"
        "    -h, --help     show help\n"
        "    -p, --print    print decompressed text to stdout\n"
        "    -t, --test     test/dry run, does not write to file\n"
        "    -d, --debug    print huffman code dictionary and performance times to stdout\n"
        "\n"
        "Commands:\n"
        "    c    compress a file\n"
        "    d    decompress a file\n"
        "\n"
        "Command Options:\n"
        "    -o, --output    output file (default: [file].et or decoded_[file])\n"
        "\n"
        "Examples:\n"
        "    entreepy -d c text.txt -o text.txt.et\n"
        "    entreepy -ptd d text.txt.et -o decoded_text.txt\n"
    )
    assert REFERENCE_HELP_TEXT == expected
    assert HELP_TEXT.startswith(expected)
    r = run_cli([], tmp_path)
    assert r.returncode == 0
    assert r.stdout.decode().startswith(expected)


def test_cli_error_message_reference_text(capsys):
    """Error message bodies match the reference's (``main.zig:112-134``):
    'invalid option: {arg}' / 'invalid command: {arg}', whole-arg even for
    clustered flags."""
    assert main(["-pz", "c", "x"]) == 1
    assert "invalid option: -pz" in capsys.readouterr().err
    assert main(["--bogus"]) == 1
    assert "invalid option: --bogus" in capsys.readouterr().err
    assert main(["compress", "x"]) == 1
    assert "invalid command: compress" in capsys.readouterr().err


def test_cli_debug_dump_dfs_order(tmp_path):
    """-d dict dump lines appear in the reference's DFS emission order
    (left-first == lexicographic code order) with raw symbol chars."""
    src = tmp_path / "t.txt"
    src.write_bytes(b"aaaabbbcc d")
    r = run_cli(["-td", "c", str(src)], tmp_path)
    assert r.returncode == 0, r.stderr
    lines = [l for l in r.stdout.decode().splitlines() if " - " in l]
    codes = [l.rsplit(" - ", 1)[1] for l in lines]
    assert codes == sorted(codes)  # lexicographic == DFS left-first
    syms = [l.rsplit(" - ", 1)[0] for l in lines]
    for s in syms:
        ch, num = s[0], s[2:]  # "{char} {byte}" — char may be a space
        assert ord(ch) == int(num)  # raw char, not a placeholder


def test_cli_corrupt_input(tmp_path):
    bad = tmp_path / "bad.et"
    bad.write_bytes(b"this is not an et file at all")
    r = run_cli(["d", str(bad)], tmp_path)
    assert r.returncode == 1
    assert b"bad magic" in r.stderr


def test_cli_empty_file(tmp_path):
    # degenerate input (SURVEY.md §2: out of the reference's contract, which
    # emits undecodable output) -> clean error, exit 1
    p = tmp_path / "empty.txt"
    p.write_bytes(b"")
    assert main(["c", str(p)]) == 1


def test_cli_backend_flag(tmp_path, macbeth):
    p = tmp_path / "m.txt"
    p.write_bytes(macbeth)
    out = tmp_path / "m.et"
    assert main(["c", str(p), "-o", str(out), "--backend", "host"]) == 0
    assert out.read_bytes() == __import__("entreepy_tpu").compress(macbeth, backend="host")
    o = parse_args(["--backend", "device", "c", "f"])
    assert o.backend == "device"
    with pytest.raises(CliError, match="invalid backend"):
        parse_args(["--backend", "gpu", "c", "f"])
    with pytest.raises(CliError, match="missing value"):
        parse_args(["c", "f", "--backend"])


def test_cli_sharded_backend_roundtrip(tmp_path, midsummer):
    # CLI round-trip over the 8-device virtual CPU mesh (VERDICT r1 item 5:
    # the flagship multi-chip path must be reachable from the product surface)
    p = tmp_path / "m.txt"
    p.write_bytes(midsummer)
    out = tmp_path / "m.et"
    dec = tmp_path / "m.out"
    assert main(["c", str(p), "-o", str(out), "--backend", "sharded"]) == 0
    assert out.read_bytes() == __import__("entreepy_tpu").compress(midsummer, backend="host")
    assert main(["d", str(out), "-o", str(dec), "--backend", "sharded"]) == 0
    assert dec.read_bytes() == midsummer


def test_cli_missing_file(tmp_path):
    r = run_cli(["c", "nope.txt"], tmp_path)
    assert r.returncode == 1
    assert b"cannot read" in r.stderr
