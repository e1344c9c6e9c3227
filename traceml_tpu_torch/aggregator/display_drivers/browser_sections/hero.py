"""Step-time hero section: the phase ribbon, the verdict and the KPI strip.

Counterpart of ``.../browser_sections/hero.py``.  The ribbon shows the
median phase shares of the selected clock; the verdict is the diagnosis
engine's step-time issue verbatim (payload ``diagnosis``), the same text
the CLI display, the final summary and the findings rail show.  One
repair against JAX: the step row of the views is keyed ``step_time``
(``utils/step_time_window.STEP_KEY``), where the JAX script looks for
``step`` and so never fills its median step, worst step, rank gap and
worst rank tiles.
"""

from __future__ import annotations

from traceml_tpu_torch.aggregator.display_drivers.browser_sections import Section

_HTML = """
<div class="chead"><h2 class="ctitle">Step time</h2><span class="sp"></span>
  <span class="cmeta" id="hero-win">waiting for steps</span>
  <span id="hero-badge"></span></div>
<div class="ribbon" id="hero-ribbon"></div>
<div class="legend" id="hero-legend" style="margin-top:.4rem"></div>
<div class="verdict" id="hero-verdict">analyzing step composition</div>
<div id="hero-sevrow" style="margin-bottom:.2rem"></div>
<div class="kpis" id="hero-kpis"></div>
"""

_JS = r"""
const HERO_KPIS=[
  ["median","MEDIAN STEP","var(--accent)"],
  ["worst","WORST STEP","#7d3dd2"],
  ["gap","RANK GAP","#f1c40f"],
  ["residual","RESIDUAL","#95a5a6"],
  ["rank","WORST RANK","#16a085"],
  ["mfu","MFU","var(--violet)"],
];
let heroBuilt=false;
function buildHero(){
  document.getElementById("hero-kpis").innerHTML=
    HERO_KPIS.map(([k,l,a])=>kpiTile(k,l,a)).join("");
  heroBuilt=true}
function render_hero(d){
  if(!heroBuilt)buildHero();
  const st=d.step_time;badge("hero-badge",d.ts,st&&st.latest_ts);
  if(st){
    const cov=st.coverage||{};
    document.getElementById("hero-win").textContent=
      `${st.n_steps} steps · ${st.clock} clock · `+
      `${cov.ranks_present}/${cov.world_size} ranks`+
      (cov.incomplete?" · INCOMPLETE":"");
    // ribbon: phase share of the step median (step row excluded)
    const phases=(st.phases||[]).filter(p=>p.key!=="step_time"&&p.share!=null);
    const tot=phases.reduce((a,p)=>a+p.share,0)||1;
    document.getElementById("hero-ribbon").innerHTML=phases.map(p=>{
      const w=(p.share/tot*100);
      return`<div class="pseg" style="background:${COLORS[p.key]||"#888"};width:${w.toFixed(2)}%">
        <span class="seglab">${w>=7?esc(p.key):""}</span></div>`}).join("");
    document.getElementById("hero-legend").innerHTML=phases.map(p=>
      `<span><i style="background:${COLORS[p.key]||"#888"}"></i>${esc(p.key)} ${pct(p.share)}</span>`).join("");
    // KPI strip
    const stepRow=(st.phases||[]).find(p=>p.key==="step_time");
    setKpi("median",stepRow?fmtMs(stepRow.median_ms).split(" ")[0]:null,
      stepRow?fmtMs(stepRow.median_ms).split(" ")[1]:"");
    setKpi("worst",stepRow?fmtMs(stepRow.worst_ms).split(" ")[0]:null,
      stepRow?fmtMs(stepRow.worst_ms).split(" ")[1]:"");
    setKpi("gap",stepRow&&stepRow.skew_pct!=null?(stepRow.skew_pct*100).toFixed(0):null,"%");
    const res=phases.find(p=>p.key==="residual");
    setKpi("residual",res?(res.share/tot*100).toFixed(0):null,"%");
    setKpi("rank",stepRow!=null&&stepRow.worst_rank!=null?"r"+stepRow.worst_rank:null,"");
    const eff=st.efficiency;
    setKpi("mfu",eff&&eff.mfu_median!=null?(eff.mfu_median*100).toFixed(0):
      (eff&&eff.achieved_tflops_median!=null?
        eff.achieved_tflops_median.toFixed(1):
        (eff&&eff.tokens_per_sec_median!=null?
          Math.round(eff.tokens_per_sec_median).toLocaleString():null)),
      eff&&eff.mfu_median!=null?"%":
        (eff&&eff.achieved_tflops_median!=null?"TF/s":
          (eff&&eff.tokens_per_sec_median!=null?"tok/s":"")));
  }
  // verdict: verbatim from the diagnosis engine — never derived here,
  // and CLEARED when the engine stops reporting (a resolved diagnosis
  // must not linger on screen)
  const diag=d.diagnosis;
  if(diag&&diag.summary){
    document.getElementById("hero-verdict").textContent=diag.summary;
    document.getElementById("hero-sevrow").innerHTML=
      `<span class="sevpill" style="background:${SEV[diag.severity]||"#555"}">${esc(diag.kind)}</span>`+
      (diag.confidence_label?` <span class="cmeta">${esc(diag.confidence_label)} confidence</span>`:"");
  }else{
    document.getElementById("hero-verdict").textContent=
      st?"step composition healthy":"analyzing step composition";
    document.getElementById("hero-sevrow").innerHTML="";
  }
}
"""

SECTION = Section(
    id="hero",
    title="Step time",
    html=_HTML,
    js=_JS,
    contract=(
        "ts",
        "step_time.latest_ts",
        "step_time.n_steps",
        "step_time.clock",
        "step_time.coverage.ranks_present",
        "step_time.coverage.world_size",
        "step_time.coverage.incomplete",
        "step_time.phases.key",
        "step_time.phases.share",
        "step_time.phases.median_ms",
        "step_time.phases.worst_ms",
        "step_time.phases.skew_pct",
        "step_time.phases.worst_rank",
        "step_time.efficiency.mfu_median",
        "step_time.efficiency.achieved_tflops_median",
        "step_time.efficiency.tokens_per_sec_median",
        "diagnosis.summary",
        "diagnosis.severity",
        "diagnosis.kind",
        "diagnosis.confidence_label",
    ),
)
