"""CLI + XML report tests."""

import json
import os
import subprocess
import sys

import pytest
import xml.etree.ElementTree as etree

from canopy_tpu.cli import main

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "demo_plant.xml")


class TestCli:
    def test_json_report(self, tmp_path, capsys):
        out = tmp_path / "report.json"
        code = main([FIXTURE, "--probability", "--ccf", "-o", str(out)])
        assert code == 0
        payload = json.loads(out.read_text())
        assert payload["model"] == "demo-plant"
        base = [r for r in payload["fault_trees"] if "alignment" not in r]
        assert base[0]["probability"] > 0

    def test_xml_report(self, tmp_path):
        out = tmp_path / "report.xml"
        code = main([FIXTURE, "--probability", "--importance",
                     "--uncertainty", "--num-trials", "200", "--ccf",
                     "-o", str(out)])
        assert code == 0
        doc = etree.parse(str(out))
        root = doc.getroot()
        assert root.tag == "report"
        assert root.find("information/software").get("name") == "canopy-tpu"
        analysis = root.find("results/fault-tree-analysis")
        assert analysis is not None
        assert float(analysis.find("probability").get("value")) > 0
        assert analysis.find("importance") is not None
        assert analysis.find("measure") is not None
        assert root.find("results/initiating-event/sequence") is not None

    def test_error_reporting(self, capsys):
        code = main(["/nonexistent/model.xml", "--probability"])
        assert code == 1
        assert "error:" in capsys.readouterr().err

    def test_mocus_flags(self, tmp_path):
        out = tmp_path / "r.json"
        code = main([FIXTURE, "--mocus", "--probability", "--ccf",
                     "--limit-order", "4", "--cut-off", "1e-12",
                     "-o", str(out)])
        assert code == 0
        payload = json.loads(out.read_text())
        base = [r for r in payload["fault_trees"] if "alignment" not in r]
        assert base[0]["method"] == "mocus/rare_event"
        assert base[0]["n_products"] >= 1


def test_build_info_git_derived():
    """Reference cmake/build-info.cmake analogue: version carries the
    git commit and history count when running from a checkout."""
    from canopy_tpu.build_info import build_info, version_string
    info = build_info()
    assert info["version"].startswith("0.")
    if info["source"] == "git":
        assert info["commit"] and info["commit_count"] > 0
        assert info["commit"] in version_string()
