"""HL008 — stale-suppression audit: an annotation that no longer
suppresses anything is itself a finding.

harlint's suppression tokens are REVIEWED CONTRACTS, not comments:
``# harlint: fetch-ok`` says "a human looked at this host sync and
accepted it"; ``ephemeral`` says "this field deliberately restarts
after recovery"; ``spec-ok`` says "this placement is
intentional".  When the code under the annotation changes — the sync
removed, the field persisted, the placement declared — the annotation
rots: it reads as an active reviewed escape while excusing nothing,
and the NEXT edit on that line inherits a free pass it never earned.
(The exact failure mode baselines have, solved there by keying entries
to the snippet; annotations need this audit instead.)

Mechanics: every rule records which ``(line, token)`` pairs actually
consumed a would-be finding (``FileContext.suppression_used``, written
by ``suppressed()`` and the generic ``disable=`` filter).  This rule
runs in ``run_rules``'s AUDIT pass — strictly after every other rule
has consumed its suppressions — and flags each annotation line whose
token consumed nothing, PROVIDED the token's owning rule ran:

    fetch-ok / host-ok -> HL001      ephemeral -> HL002
    spec-ok            -> HL007      disable=HL00X -> HL00X

(the ownership guard keeps a ``--rule HL004`` subset run from calling
every HL001 annotation stale).  ``run_harlint`` drops this rule on
path-subset runs (``lint --changed``, explicit paths): staleness
is a whole-fileset property — HL001's launch closure must actually be
computed for its annotations to be judged — exactly as HL003's
bijections only hold over the full set.

A deliberate consequence: an annotation in a file its rule never scans
(a ``host-ok`` in a module the launch surface cannot reach) is flagged
too.  That is the policy working: the reviewed contract claims
protection that is not happening, so either the reachability gap or
the annotation is wrong — both deserve a finding.
"""

from __future__ import annotations

from har_tpu_torch.analyze.core import FileContext, Finding, Rule, walk_scopes

# token -> the rule whose findings it suppresses
TOKEN_OWNERS = {
    "fetch-ok": "HL001",
    "host-ok": "HL001",
    "ephemeral": "HL002",
    "spec-ok": "HL007",
}


class _Anchor:
    """Line-anchored pseudo-node for Finding construction."""

    def __init__(self, lineno: int):
        self.lineno = lineno
        self.end_lineno = lineno


class SuppressionAuditRule(Rule):
    rule_id = "HL008"
    title = "stale suppression"

    def audit(
        self, ctxs: list[FileContext], ran: list[str]
    ) -> list[Finding]:
        ran_set = set(ran)
        findings: list[Finding] = []
        for ctx in ctxs:
            if not ctx.suppressions:
                continue
            symbols = self._symbol_map(ctx)
            for line in sorted(ctx.suppressions):
                for token in sorted(ctx.suppressions[line]):
                    owner = (
                        token.split("=", 1)[1]
                        if token.startswith("disable=")
                        else TOKEN_OWNERS.get(token)
                    )
                    if owner is None or owner not in ran_set:
                        continue  # owning rule didn't run: unjudgeable
                    if owner == self.rule_id:
                        continue  # disable=HL008 is consumed below us
                    if (line, token) in ctx.suppression_used:
                        continue
                    findings.append(
                        ctx.finding(
                            self.rule_id,
                            _Anchor(line),
                            f"stale `# harlint: {token}` — {owner} ran "
                            "and this annotation suppressed nothing "
                            "(the sync/field/spec it reviewed is gone, "
                            "or the line no longer triggers the rule); "
                            "remove it so the reviewed contract cannot "
                            "rot onto a future edit",
                            symbols.get(line, ""),
                        )
                    )
        return findings

    @staticmethod
    def _symbol_map(ctx: FileContext) -> dict[int, str]:
        """line -> innermost enclosing def/class qualname (pre-order
        walk: deeper scopes overwrite their parents' lines)."""
        out: dict[int, str] = {}
        for qual, node in walk_scopes(ctx.tree):
            for ln in range(
                node.lineno, (node.end_lineno or node.lineno) + 1
            ):
                out[ln] = qual
        return out
