"""Prompt template macro expansion.

A copy of ``ltx_video_gpupoor_tpu/utils/prompt_templates.py`` (no JAX).

Parity target: ``process_template`` at
``wan/utils/prompt_parser.py`` — ``!{var}="a","b" : ...``
macro lines declare variable value lists; following template lines are
expanded once per value combination (cycling shorter lists), producing a
prompt batch. Errors reported as (``""``, message) exactly like the
reference.
"""

from __future__ import annotations

import re


def process_template(input_text: str) -> tuple[str, str]:
    lines = input_text.strip().split("\n")
    variables: dict[str, list[str]] = {}
    template_lines: list[str] = []
    output: list[str] = []

    def flush() -> str:
        nonlocal template_lines
        if not template_lines:
            return ""
        expanded, err = _expand(template_lines, variables)
        if err:
            return err
        output.extend(expanded)
        template_lines = []
        return ""

    for orig_line in lines:
        line = orig_line.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("!"):
            err = flush()
            if err:
                return "", err
            variables = {}
            macro = line[1:].strip()
            if macro.count("{") != macro.count("}"):
                return "", (
                    f"Unmatched braces: {macro.count('{')} opening '{{' and "
                    f"{macro.count('}')} closing '}}' braces\n"
                    f"Line: '{orig_line}'"
                )
            if macro.count('"') % 2 != 0:
                return "", f"Unclosed double quotes\nLine: '{orig_line}'"
            for section in re.split(r"\s*:\s*", macro):
                section = section.strip()
                if not section:
                    continue
                m = re.search(r"\{([^}]+)\}", section)
                if not m:
                    if "{" in section or "}" in section:
                        return "", (
                            f"Malformed variable declaration\n"
                            f"Line: '{orig_line}'"
                        )
                    continue
                name = m.group(1).strip()
                if not name:
                    return "", f"Empty variable name\nLine: '{orig_line}'"
                value_part = section[section.find("}") + 1:].strip()
                if not value_part.startswith("="):
                    return "", (
                        f"Missing '=' after variable '{{{name}}}'\n"
                        f"Line: '{orig_line}'"
                    )
                values = re.findall(r'"([^"]*)"', value_part)
                if not values:
                    return "", (
                        f"No quoted values found for variable '{{{name}}}'\n"
                        f"Line: '{orig_line}'"
                    )
                if re.search(r'"[^,]*"[^,]*"', value_part):
                    return "", (
                        f"Missing comma between values for variable "
                        f"'{{{name}}}'\nLine: '{orig_line}'"
                    )
                variables[name] = values
        else:
            for ref in re.findall(r"\{([^}]+)\}", line):
                if ref not in variables:
                    return "", (
                        f"Unknown variable '{{{ref}}}' in template\n"
                        f"Line: '{orig_line}'"
                    )
            template_lines.append(line)

    err = flush()
    if err:
        return "", err
    return "\n".join(output), ""


def _expand(template_lines, variables):
    if not variables or not template_lines:
        return template_lines, ""
    out = []
    max_values = max(len(v) for v in variables.values())
    for i in range(max_values):
        for template in template_lines:
            line = template
            for name, values in variables.items():
                line = line.replace(f"{{{name}}}", values[i % len(values)])
            out.append(line)
    return out, ""
