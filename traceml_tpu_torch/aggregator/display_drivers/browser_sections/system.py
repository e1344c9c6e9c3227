"""System section and the GPU-busy gauge.

Counterpart of ``.../browser_sections/system.py``.  The gauge is an SVG
ring over the best busy signal: the NVML utilization of the device rows
(the ``utilization_pct`` field that ``samplers/system_sampler.py`` fills
from NVML; JAX: libtpu's duty cycle), else the step-time view's median
occupancy (the device-busy share of the wall), labelled with its source.
Labels: "GPU busy" (JAX: "Chip busy"), "NVML utilization", "mean across
reporting GPUs".  The CPU history chart has the step chart's crosshair
tooltip.
"""

from __future__ import annotations

from traceml_tpu_torch.aggregator.display_drivers.browser_sections import Section

_HTML = """
<div class="chead"><h2 class="ctitle">System</h2><span class="sp"></span>
  <span id="sys-badge"></span></div>
<svg id="sys-cpu" class="spark" viewBox="0 0 600 64" preserveAspectRatio="none"></svg>
<div class="muted" id="sys-cpu-cap" style="margin-bottom:.4rem"></div>
<div id="system"></div>
"""

_GAUGE_HTML = """
<div class="chead"><h2 class="ctitle">GPU busy</h2><span class="sp"></span>
  <span class="cmeta" id="gauge-src"></span></div>
<div style="display:flex;justify-content:center;padding:.4rem 0">
<svg id="gauge" width="170" height="150" viewBox="0 0 170 150">
  <path d="M 25 125 A 70 70 0 1 1 145 125" fill="none"
    stroke="rgba(233,236,245,0.08)" stroke-width="13" stroke-linecap="round"/>
  <path id="gauge-arc" d="M 25 125 A 70 70 0 1 1 145 125" fill="none"
    stroke="var(--accent)" stroke-width="13" stroke-linecap="round"
    stroke-dasharray="0 1000" style="transition:stroke-dasharray .6s"/>
  <text id="gauge-val" x="85" y="92" text-anchor="middle"
    font-family="var(--mono)" font-size="30" font-weight="600"
    fill="var(--ink)">—</text>
</svg></div>
<div class="muted" id="gauge-note" style="text-align:center"></div>
"""

_JS = r"""
let sysLast=null;
function render_system(d){
  const s=d.system;badge("sys-badge",d.ts,s&&s.latest_ts);
  const el=document.getElementById("system");
  sysLast=s;
  if(!s||!s.nodes||!s.nodes.length){
    el.innerHTML='<span class="muted">no system telemetry</span>';
    document.getElementById("sys-cpu").innerHTML="";
    document.getElementById("sys-cpu-cap").textContent="";
    render_gauge(d);return}
  // cpu history chart (one line per node)
  const svg=document.getElementById("sys-cpu");
  let paths="";
  s.nodes.forEach((n,ni)=>{const h=n.cpu_history||[];if(h.length<2)return;
    paths+=`<polyline fill="none" stroke="${rankColor(ni)}" stroke-width="1.5"
      points="${sparkPath(h,600,64,100)}"/>`});
  svg.innerHTML=paths;
  document.getElementById("sys-cpu-cap").textContent=
    paths?"host cpu % (window tail, one line per node)":"";
  hookTip("sys-cpu",frac=>{
    if(!sysLast||!sysLast.nodes)return null;
    let h="";
    for(const n of sysLast.nodes){const hist=n.cpu_history||[];
      if(hist.length<2)continue;
      const i=Math.min(hist.length-1,Math.floor(frac*hist.length));
      h+=`${h?"<br>":""}${esc(n.hostname)}: ${hist[i].toFixed(0)}%`}
    return h||null});
  let rows=`<table><tr><th>node</th><th class="num">cpu</th>
    <th class="num">host mem</th><th class="num">load</th><th></th></tr>`;
  for(const n of s.nodes){
    rows+=`<tr><td>${esc(n.hostname)} (#${esc(n.node_rank)})</td>
      <td class="num">${n.cpu_pct==null?"n/a":n.cpu_pct.toFixed(0)+"%"}</td>
      <td class="num">${fmtB(n.memory_used_bytes)} / ${fmtB(n.memory_total_bytes)}</td>
      <td class="num">${n.load_1m==null?"—":n.load_1m.toFixed(1)}</td>
      <td>${n.stale?'<span class="badge stale">stale</span>':""}</td></tr>`}
  const devs=[];for(const n of s.nodes)for(const dv of n.devices||[])devs.push([n,dv]);
  if(devs.length){
    rows+=`</table><table><tr><th>node</th><th class="num">dev</th><th>kind</th>
      <th class="num">mem</th><th class="num">util</th><th class="num">temp</th>
      <th class="num">power</th></tr>`;
    for(const[n,dv]of devs){
      rows+=`<tr><td>${esc(n.hostname)}</td><td class="num">${esc(dv.device_id)}</td>
        <td>${esc(dv.device_kind)}</td>
        <td class="num">${dv.memory_used_bytes==null?"—":fmtB(dv.memory_used_bytes)+" / "+fmtB(dv.memory_total_bytes)}</td>
        <td class="num">${dv.utilization_pct==null?"—":dv.utilization_pct.toFixed(0)+"%"}</td>
        <td class="num">${dv.temperature_c==null?"—":dv.temperature_c.toFixed(0)+"°C"}</td>
        <td class="num">${dv.power_w==null?"—":dv.power_w.toFixed(0)+"W"}</td></tr>`}}
  el.innerHTML=rows+"</table>";
  render_gauge(d)}
function render_gauge(d){
  // best busy signal: NVML utilization (device rows) > step occupancy
  let val=null,src="";
  const s=d.system;
  if(s&&s.nodes){const utils=[];
    for(const n of s.nodes)for(const dv of n.devices||[])
      if(dv.utilization_pct!=null)utils.push(dv.utilization_pct);
    if(utils.length){
      val=utils.reduce((a,b)=>a+b,0)/utils.length;src="NVML utilization"}}
  const st=d.step_time;
  if(val==null&&st&&st.median_occupancy!=null){
    val=st.median_occupancy*100;src="step occupancy"}
  const arc=document.getElementById("gauge-arc");
  const txt=document.getElementById("gauge-val");
  // arc length of the 290° ring at r=70 ≈ 354px
  const LEN=354;
  if(val==null){arc.setAttribute("stroke-dasharray","0 1000");
    txt.textContent="—";
    document.getElementById("gauge-src").textContent="";
    document.getElementById("gauge-note").textContent="no busy signal yet";
    return}
  const v=Math.max(0,Math.min(100,val));
  arc.setAttribute("stroke-dasharray",`${(v/100*LEN).toFixed(1)} 1000`);
  arc.setAttribute("stroke",v>=85?"var(--good)":v>=50?"var(--accent)":"var(--warn)");
  txt.textContent=v.toFixed(0)+"%";
  document.getElementById("gauge-src").textContent=src;
  document.getElementById("gauge-note").textContent=
    src==="step occupancy"?"device-busy share of wall (step window)":
    "mean across reporting GPUs"}
"""

SECTION = Section(
    id="system",
    title="System",
    html=_HTML,
    js=_JS,
    contract=(
        "ts",
        "system.latest_ts",
        "system.nodes.hostname",
        "system.nodes.node_rank",
        "system.nodes.cpu_pct",
        "system.nodes.cpu_history",
        "system.nodes.memory_used_bytes",
        "system.nodes.memory_total_bytes",
        "system.nodes.load_1m",
        "system.nodes.stale",
        "system.nodes.devices.device_id",
        "system.nodes.devices.device_kind",
        "system.nodes.devices.memory_used_bytes",
        "system.nodes.devices.memory_total_bytes",
        "system.nodes.devices.utilization_pct",
        "system.nodes.devices.temperature_c",
        "system.nodes.devices.power_w",
        "step_time.median_occupancy",
    ),
)

GAUGE_SECTION = Section(
    id="gauge",
    title="GPU busy",
    html=_GAUGE_HTML,
    js="",  # driven by render_system (one subscriber per payload, like the ref)
    contract=(
        "system.nodes.devices.utilization_pct",
        "step_time.median_occupancy",
    ),
)
