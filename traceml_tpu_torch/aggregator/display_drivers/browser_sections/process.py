"""Process section: the per-rank process table and its KPIs (p95 CPU,
total RSS, busiest rank).

Counterpart of ``.../browser_sections/process.py`` (copied); imbalance
verdicts stay with the diagnosis engine.
"""

from __future__ import annotations

from traceml_tpu_torch.aggregator.display_drivers.browser_sections import Section

_HTML = """
<div class="chead"><h2 class="ctitle">Processes</h2><span class="sp"></span>
  <span id="proc-badge"></span></div>
<div class="kpis" id="proc-kpis" style="margin:.1rem 0 .6rem"></div>
<div id="process"></div>
"""

_JS = r"""
let procBuilt=false;
function buildProc(){
  document.getElementById("proc-kpis").innerHTML=
    kpiTile("proc-cpu","P95 CPU","var(--accent)")+
    kpiTile("proc-rss","TOTAL RSS","var(--violet)")+
    kpiTile("proc-busy","BUSIEST","#16a085");
  procBuilt=true}
function render_process(d){
  if(!procBuilt)buildProc();
  const p=d.process;badge("proc-badge",d.ts,p&&p.latest_ts);
  const el=document.getElementById("process");
  if(!p||!p.ranks||!p.ranks.length){
    el.innerHTML='<span class="muted">no process telemetry</span>';return}
  const cpus=p.ranks.map(s=>s.cpu_pct).filter(v=>v!=null).sort((a,b)=>a-b);
  const p95=cpus.length?cpus[Math.min(cpus.length-1,
    Math.floor(0.95*(cpus.length-1)))]:null;
  setKpi("proc-cpu",p95==null?null:p95.toFixed(0),"%");
  setKpi("proc-rss",fmtB(p.total_rss_bytes).split(" ")[0],
    fmtB(p.total_rss_bytes).split(" ")[1]);
  setKpi("proc-busy",p.busiest_rank==null?null:"r"+p.busiest_rank,"");
  let rows=`<table><tr><th class="num">rank</th><th>host</th><th class="num">pid</th>
    <th class="num">cpu</th><th class="num">rss</th><th class="num">threads</th><th></th></tr>`;
  for(const s of p.ranks){
    const hot=s.rank===p.busiest_rank?' style="color:#ffd27f"':"";
    rows+=`<tr><td class="num">${esc(s.rank)}</td><td>${esc(s.hostname)}</td>
      <td class="num">${esc(s.pid==null?"—":s.pid)}</td>
      <td class="num"${hot}>${s.cpu_pct==null?"n/a":s.cpu_pct.toFixed(0)+"%"}</td>
      <td class="num">${fmtB(s.rss_bytes)}</td>
      <td class="num">${esc(s.num_threads==null?"—":s.num_threads)}</td>
      <td>${s.stale?'<span class="badge stale">stale</span>':""}</td></tr>`}
  el.innerHTML=rows+"</table>"}
"""

SECTION = Section(
    id="process",
    title="Processes",
    html=_HTML,
    js=_JS,
    contract=(
        "ts",
        "process.latest_ts",
        "process.ranks.rank",
        "process.ranks.hostname",
        "process.ranks.pid",
        "process.ranks.cpu_pct",
        "process.ranks.rss_bytes",
        "process.ranks.num_threads",
        "process.ranks.stale",
        "process.busiest_rank",
        "process.total_rss_bytes",
    ),
)
