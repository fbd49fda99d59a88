"""'Explain Computation' reports (capability parity with the reference's
``pipeline_dp/report_generator.py``): each aggregation collects an ordered
list of stage descriptions — strings or zero-arg callables evaluated lazily
so budget values resolved only after ``compute_budgets()`` still render
(reference :66-75; consumed from ``dp_engine`` stages).

Stages are stored as STRUCTURED dicts (text + optional machine-readable
fields from ``add_stage(..., **fields)``); :meth:`ReportGenerator.report`
keeps rendering the reference's string view, while
:meth:`ReportGenerator.structured` feeds the run report's privacy audit
section (``obs.audit``) with the same stages as data."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Union

from pipelinedp_tpu_torch import aggregate_params as agg


class ReportGenerator:
    """Collects stages of one DP aggregation (reference :46-89)."""

    def __init__(self,
                 params,
                 method_name: str,
                 is_public_partition: Optional[bool] = None):
        self._params_str = None
        if params:
            if isinstance(params, agg.AggregateParams):
                self._params_str = agg.parameters_to_readable_string(
                    params, is_public_partition)
            else:
                self._params_str = str(params)
        self._method_name = method_name
        self._stages: List[Dict[str, Any]] = []

    def add_stage(self, stage_description: Union[Callable, str],
                  **fields) -> None:
        """Record one stage: the text (str, or a zero-arg callable
        evaluated lazily at render time) plus optional structured
        ``fields`` surfaced verbatim by :meth:`structured`."""
        self._stages.append({"text": stage_description, **fields})

    def add_stages(self, stage_descriptions) -> None:
        for s in stage_descriptions:
            self.add_stage(s)

    def report(self) -> str:
        if not self._params_str:
            return ""
        lines = [f"DPEngine method: {self._method_name}", self._params_str,
                 "Computation graph:"]
        for i, stage in enumerate(self._stages):
            text = stage["text"]
            text = text() if callable(text) else text
            lines.append(f" {i + 1}. {text}")
        return "\n".join(lines)

    def stages(self) -> List[Dict[str, Any]]:
        """The structured stage view: evaluated text + any structured
        fields, one dict per stage (lazy callables resolve here, so call
        after ``compute_budgets()`` for final budget values)."""
        out = []
        for i, stage in enumerate(self._stages):
            d = {k: v for k, v in stage.items() if k != "text"}
            text = stage["text"]
            d["stage"] = i + 1
            d["text"] = str(text() if callable(text) else text)
            out.append(d)
        return out

    def structured(self) -> Dict[str, Any]:
        """Machine-readable twin of :meth:`report`."""
        return {"method": self._method_name,
                "params": self._params_str,
                "stages": self.stages()}


class ExplainComputationReport:
    """User-facing handle for one aggregation's report (reference :92-115)."""

    def __init__(self):
        self._report_generator: Optional[ReportGenerator] = None

    def _set_report_generator(self, report_generator: ReportGenerator):
        self._report_generator = report_generator

    def text(self) -> str:
        if self._report_generator is None:
            raise ValueError(
                "The report_generator is not set.\nWas this object passed as "
                "an argument to a DP aggregation method?")
        try:
            return self._report_generator.report()
        except Exception as e:
            raise ValueError(
                "Explain computation report failed to be generated.\nWas "
                "BudgetAccountant.compute_budgets() called?") from e

    def structured(self) -> dict:
        """The structured stage view (see ``ReportGenerator.structured``)."""
        if self._report_generator is None:
            raise ValueError(
                "The report_generator is not set.\nWas this object passed as "
                "an argument to a DP aggregation method?")
        try:
            return self._report_generator.structured()
        except Exception as e:
            raise ValueError(
                "Explain computation report failed to be generated.\nWas "
                "BudgetAccountant.compute_budgets() called?") from e
